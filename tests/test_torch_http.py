"""The port's own HTTP layer (``sitewhere_tpu_torch/web/http.py``) held to
``aiohttp.web``: one small application is written twice, once on each, and
the same requests (sent with aiohttp's client, then with the port's
stdlib client) must get the same statuses, headers that matter and
bodies — routing order, 404 / 405 with ``Allow``, HEAD on GET routes,
percent-decoded path variables, repeated query keys, request bodies,
middleware order, raised HTTP errors, 500 on an unhandled error, the body
size limit, read before the body is held, and the rest of an unread
body dropped with the connection kept; idle connections close. Then the gateway: HEAD on every GET route of the REST app
answers as JAX's does, its OpenAPI document equals JAX's, and a
connection is kept alive across requests."""

import asyncio
import re

import aiohttp
from aiohttp import web as aioweb

from sitewhere_tpu_torch.web import http
from tests.test_torch_rest_api import route_table
from tests.torch_servers import BOTH, make_instance, pin_servers

KEPT = ("Content-Type", "Allow", "Connection", "X-Order")


def build(web):
    """The same application on ``web`` (``aiohttp.web`` or the port's
    ``http``)."""
    @web.middleware
    async def outer(request, handler):
        request["order"] = ["outer"]
        resp = await handler(request)
        resp.headers["X-Order"] = ",".join(request["order"] + ["outer-out"])
        return resp

    @web.middleware
    async def inner(request, handler):
        request["order"].append("inner")
        if request.headers.get("X-Deny") == "1":
            return web.json_response({"error": "denied"}, status=403)
        return await handler(request)

    app = web.Application(middlewares=[outer, inner])
    r = app.router

    async def plain(request):
        """A JSON answer."""
        return web.json_response({"ok": True, "path": request.path})

    async def text(request):
        return web.Response(text="hello", content_type="text/plain")

    async def png(request):
        return web.Response(body=b"\x89PNG-bytes", content_type="image/png")

    async def empty(request):
        return web.Response()

    async def echo(request):
        return web.json_response({
            "match": dict(request.match_info),
            "q": request.query.get("q"), "all": request.query.getall("k", []),
            "missing": request.query.getall("nope", None),
            "method": request.method})

    async def body(request):
        can, length = request.can_read_body, request.content_length
        data = await request.json() if can else None
        return web.json_response({"can": can, "length": length, "data": data,
                                  "after": request.can_read_body},
                                 status=201, headers={"Retry-After": "3"})

    async def raw(request):
        data = await request.read()
        return web.json_response({"n": len(data)})

    async def nf(request):
        raise web.HTTPNotFound(text="engine is not clustered")

    async def forbidden(request):
        raise web.HTTPForbidden(text="no")

    async def bare_nf(request):
        raise web.HTTPNotFound()

    async def boom(request):
        raise RuntimeError("boom")

    async def key_error(request):
        return web.json_response({"v": request.query["required"]})

    r.add_get("/a", plain)
    r.add_post("/a", body)
    r.add_put("/a", plain)
    r.add_get("/text", text)
    r.add_get("/png", png)
    r.add_get("/empty", empty)
    r.add_get("/items/literal", plain)
    r.add_get("/items/{token}", echo)
    r.add_delete("/items/{token}", echo)
    r.add_get("/items/{token}/sub/{other}", echo)
    r.add_get("/x/{a}/y", echo)
    r.add_post("/x/{a}/{b}", echo)
    r.add_post("/raw", raw)
    r.add_get("/nf", nf)
    r.add_get("/forbidden", forbidden)
    r.add_get("/bare-nf", bare_nf)
    r.add_get("/boom", boom)
    r.add_get("/key", key_error)
    return app


REQUESTS = [
    ("GET", "/a", {}, None),
    ("HEAD", "/a", {}, None),
    ("PUT", "/a", {}, None),
    ("DELETE", "/a", {}, None),              # 405, Allow GET,HEAD,POST,PUT
    ("OPTIONS", "/a", {}, None),
    ("POST", "/a", {"json": {"x": [1, 2]}}, None),
    ("POST", "/a", {}, None),                # no body: can_read_body False
    ("GET", "/text", {}, None),
    ("HEAD", "/text", {}, None),
    ("GET", "/png", {}, None),
    ("GET", "/empty", {}, None),
    ("GET", "/items/literal", {}, None),     # the literal wins over {token}
    ("GET", "/items/a%2Fb%20c%25d", {}, None),
    ("GET", "/items/%C3%A9t%C3%A9", {}, None),
    ("DELETE", "/items/t-1", {}, None),
    ("POST", "/items/t-1", {}, None),        # 405, Allow DELETE,GET,HEAD
    ("GET", "/items/t-1/sub/u-2", {}, None),
    ("GET", "/items/t-1/sub", {}, None),     # 404
    ("GET", "/x/1/y", {}, None),
    ("GET", "/x/1/z", {}, None),             # matches POST /x/{a}/{b}: 405
    ("POST", "/x/1/z", {}, None),
    ("GET", "/items/q?q=1&k=a&k=b&k=", {}, None),
    ("GET", "/items/q", {"params": {"q": "a b+c", "k": "é"}}, None),
    ("GET", "/nowhere", {}, None),
    ("GET", "/nf", {}, None),
    ("GET", "/forbidden", {}, None),
    ("GET", "/bare-nf", {}, None),
    ("GET", "/key", {}, None),               # KeyError -> 500
    ("GET", "/boom", {}, None),              # 500, connection closed
    ("GET", "/a", {"headers": {"X-Deny": "1"}}, None),
    ("POST", "/raw", {"data": b"x" * 1000}, None),
    ("POST", "/raw", {"data": b"x" * (1024 ** 2 + 1)}, None),   # 413
]


def serve(web, app, loop):
    """Serve ``app`` on ``web``; returns ``(port, close)``."""
    if web is aioweb:
        runner = aioweb.AppRunner(app)
        loop.run_until_complete(runner.setup())
        site = aioweb.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        return site._server.sockets[0].getsockname()[1], runner.cleanup
    server = loop.run_until_complete(http.serve(app))
    return server.port, server.close


async def _aiohttp_send(base, reqs):
    out = []
    async with aiohttp.ClientSession() as s:
        for method, path, kw, _ in reqs:
            async with s.request(method, base + path, **kw) as r:
                out.append((method, path, r.status,
                            {k: r.headers.get(k) for k in KEPT},
                            await r.read()))
    return out


async def _stdlib_send(base, reqs):
    out = []
    async with http.ClientSession() as s:
        for method, path, kw, _ in reqs:
            kw = dict(kw)
            r = await s.request(method, base + path, **kw)
            out.append((method, path, r.status,
                        {k: r.headers.get(k) for k in KEPT}, r.body))
    return out


def _both_servers(send):
    out = []
    for web in (aioweb, http):
        loop = asyncio.new_event_loop()
        port, close = serve(web, build(web), loop)
        try:
            out.append(loop.run_until_complete(
                send(f"http://127.0.0.1:{port}", REQUESTS)))
        finally:
            loop.run_until_complete(close())
            loop.close()
    return out


def test_port_http_answers_as_aiohttp_web_does():
    ref, got = _both_servers(_aiohttp_send)
    assert len(got) == len(ref) == len(REQUESTS)
    for a, b in zip(ref, got):
        assert b == a, f"port {b!r}\n  != aiohttp {a!r}"
    # spot checks of what the comparison covers
    by = {(m, p): (st, h, body) for m, p, st, h, body in got}
    assert by[("DELETE", "/a")][0] == 405
    assert by[("DELETE", "/a")][1]["Allow"] == "GET,HEAD,POST,PUT"
    assert by[("HEAD", "/a")][2] == b""
    assert b'"a/b c%d"' in by[("GET", "/items/a%2Fb%20c%25d")][2]
    assert b'"all": ["a", "b", ""]' in by[("GET", "/items/q?q=1&k=a&k=b&k=")][2]
    assert by[("GET", "/boom")][:2] == (500, {
        "Content-Type": "text/plain; charset=utf-8", "Allow": None,
        "Connection": "close", "X-Order": None})
    assert by[("GET", "/boom")][2] == (b"500 Internal Server Error\n\n"
                                       b"Server got itself in trouble")
    assert by[("POST", "/raw")][0] == 413


def test_stdlib_client_reads_both_servers_alike():
    """The port's client against aiohttp's server and against the port's:
    the same answers (the client framing, keep-alive reuse after a 500's
    close, HEAD without a body)."""
    ref, got = _both_servers(_stdlib_send)
    for a, b in zip(ref, got):
        assert b == a, f"port {b!r}\n  != aiohttp {a!r}"
    # and the stdlib client reads what aiohttp's client reads
    aio, _ = _both_servers(_aiohttp_send)
    assert [(m, p, st, body) for m, p, st, _, body in ref] == \
        [(m, p, st, body) for m, p, st, _, body in aio]


def test_keep_alive_serves_many_requests_on_one_connection():
    loop = asyncio.new_event_loop()
    app = build(http)
    server = loop.run_until_complete(http.serve(app))
    accepted = []
    orig = server._connection

    async def counting(reader, writer):
        accepted.append(1)
        await orig(reader, writer)

    server._server.close()
    loop.run_until_complete(server._server.wait_closed())
    server._server = loop.run_until_complete(
        asyncio.start_server(counting, "127.0.0.1", server.port))

    async def go():
        async with http.ClientSession() as s:
            for i in range(20):
                r = await s.get(f"http://127.0.0.1:{server.port}/items/{i}")
                assert r.status == 200 and (await r.json())["match"] == {"token": str(i)}
            r = await s.post(f"http://127.0.0.1:{server.port}/a", json={"i": 1})
            assert r.status == 201
            return len(s._idle[("127.0.0.1", server.port)])

    try:
        idle = loop.run_until_complete(go())
    finally:
        loop.run_until_complete(server.close())
        loop.close()
    assert idle == 1 and len(accepted) == 1


# ------------------------------------------------- bodies and idle connections
def _on_server(web, go):
    """``go(port)`` against ``build(web)`` served on its own loop."""
    loop = asyncio.new_event_loop()
    port, close = serve(web, build(web), loop)
    try:
        return loop.run_until_complete(asyncio.wait_for(go(port), 30))
    finally:
        loop.run_until_complete(close())
        loop.close()


async def _answer(reader) -> tuple[int, bytes]:
    """The status and body of the next answer on a raw connection."""
    head = await http._read_head(reader)
    return int(head[0].split(" ")[1]), await http._read_body(
        reader, http._parse_headers(head[1:]))


def _head(method, path, **headers) -> bytes:
    lines = [f"{method} {path} HTTP/1.1", "Host: 127.0.0.1"]
    lines += [f"{k.replace('_', '-')}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


def test_declared_body_past_the_limit_answers_413_before_it_is_read():
    """A ``Content-Length`` of 1 GiB: the handler's read answers 413 with
    aiohttp's text at once, with 1000 bytes of the body sent, so the
    server never holds the body; a middleware that refuses first answers
    without reading any of it."""
    async def go(port):
        out = []
        for extra in ({}, {"X_Deny": "1"}):
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            path = "/raw" if not extra else "/a"
            writer.write(_head("POST", path, Content_Length=1 << 30, **extra) + b"x" * 1000)
            await writer.drain()
            out.append(await _answer(reader))
            writer.close()
        return out

    (status, body), (deny, _) = _on_server(http, go)
    assert status == 413
    assert body == (b"Maximum request body size 1048576 exceeded, "
                    b"actual body size 1073741824")
    assert deny == 403


def test_chunked_body_past_the_limit_answers_413_and_the_connection_goes_on():
    """A chunked body of 17 pieces of 64 KiB: 413 once 1 MiB has come
    (the size read so far in the text, as aiohttp's), the rest read
    and dropped, and the next request on the same connection answered, on
    aiohttp's server as on the port's."""
    async def go(port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        piece = b"%x\r\n" % (1 << 16) + b"y" * (1 << 16) + b"\r\n"
        writer.write(_head("POST", "/raw", Transfer_Encoding="chunked")
                     + piece * 17 + b"0\r\n\r\n" + _head("GET", "/a"))
        await writer.drain()
        first, second = await _answer(reader), await _answer(reader)
        writer.close()
        return first, second

    for web in (aioweb, http):
        (status, body), (after, doc) = _on_server(web, go)
        assert status == 413, web
        size = int(body.rsplit(b" ", 1)[1])
        assert body.startswith(b"Maximum request body size 1048576 exceeded, actual body size ")
        # aiohttp counts what has come when it checks; the port stops at
        # the piece that reaches the limit
        assert (1 << 20) <= size <= 17 << 16 if web is aioweb else size == 1 << 20
        assert (after, doc) == (200, b'{"ok": true, "path": "/a"}'), web


def test_unread_body_is_dropped_and_the_connection_kept():
    """A 3 MiB body that the middleware refuses unread: 403, then the next
    request on the same connection answers, as on aiohttp's server."""
    async def go(port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(_head("POST", "/a", Content_Length=3 << 20, X_Deny="1")
                     + b"z" * (3 << 20) + _head("GET", "/a"))
        await writer.drain()
        out = [(await _answer(reader))[0], await _answer(reader)]
        writer.close()
        return out

    got = [_on_server(web, go) for web in (aioweb, http)]
    assert got[1] == got[0] == [403, (200, b'{"ok": true, "path": "/a"}')]


def test_idle_connection_closes_after_the_keepalive_timeout(monkeypatch):
    """A connection that sends nothing, and one idle after an answer, are
    closed once ``KEEPALIVE_TIMEOUT_S`` passes."""
    monkeypatch.setattr(http, "KEEPALIVE_TIMEOUT_S", 0.2)

    async def go(port):
        quiet = await asyncio.open_connection("127.0.0.1", port)
        used = await asyncio.open_connection("127.0.0.1", port)
        used[1].write(_head("GET", "/a"))
        await used[1].drain()
        answered = await _answer(used[0])
        ends = [await asyncio.wait_for(r.read(), 10) for r, _ in (quiet, used)]
        for _, w in (quiet, used):
            w.close()
        return answered, ends

    answered, ends = _on_server(http, go)
    assert answered[0] == 200 and ends == [b"", b""]


# ------------------------------------------------------------ the gateway
def _get_routes(app) -> list[str]:
    out = []
    for route in app.router.routes():
        if route.method == "GET":
            info = route.resource.get_info()
            out.append(info.get("path") or info.get("formatter"))
    return out


def test_head_on_every_get_route_answers_as_jax(monkeypatch):
    """Every GET route of the gateway also answers HEAD, as aiohttp's
    ``add_get`` registers it: the same status and Content-Type as the JAX
    gateway's answer to the same HEAD, and no body."""
    from tests.torch_servers import rest_side

    pin_servers(monkeypatch)
    seen = []
    for P in BOTH:
        with rest_side(P) as S:
            paths = _get_routes(S.P.mod("web.rest").make_app(S.inst))
            out = []
            for p in paths:
                url = re.sub(r"\{(\w+)\}", r"x-\1", p)
                status, body = S.call(
                    "HEAD", url, raw=True, keep=lambda b: b,
                    params={"seconds": "0.02", "ms": "50"})
                assert body == b""
                out.append((p, status, S.log[-1][4]["Content-Type"]))
            seen.append(out)
    assert len(seen[1]) == len(seen[0]) == 109
    assert seen[1] == seen[0]


def test_openapi_document_equals_jax(monkeypatch):
    """``/api/openapi.json`` lists the same paths and methods (HEAD with
    every GET) with the same summaries; the port's docstrings drop the JAX
    package's issue tags and name ``torch.profiler``."""
    pin_servers(monkeypatch)
    specs = []
    for P in BOTH:
        app = P.mod("web.rest").make_app(make_instance(P))
        loop = asyncio.new_event_loop()
        try:
            if P.port:
                server = loop.run_until_complete(http.serve(app))
                port, close = server.port, server.close
            else:
                port, close = serve(aioweb, app, loop)

            async def get():
                async with aiohttp.ClientSession() as s:
                    import base64
                    basic = base64.b64encode(b"admin:password").decode()
                    async with s.get(f"http://127.0.0.1:{port}/api/authapi/jwt",
                                     headers={"Authorization": f"Basic {basic}"}) as r:
                        tok = (await r.json())["token"]
                    async with s.get(f"http://127.0.0.1:{port}/api/openapi.json",
                                     headers={"Authorization": f"Bearer {tok}"}) as r:
                        return await r.json()

            specs.append(loop.run_until_complete(get()))
            loop.run_until_complete(close())
        finally:
            loop.close()
    j, t = specs
    assert route_table(t) == route_table(j)
    assert {p: sorted(ops) for p, ops in t["paths"].items()} == \
        {p: sorted(ops) for p, ops in j["paths"].items()}
    n_routes = sum(len(ops) for ops in t["paths"].values())
    assert len(t["paths"]) == 135 and n_routes == 308


def test_port_http_imports_nothing_outside_the_standard_library():
    import sys

    src = open(http.__file__).read()
    imported = set(re.findall(r"^\s*(?:import|from)\s+([\w.]+)", src, re.M))
    assert all(m.split(".")[0] in sys.stdlib_module_names or m == "__future__"
               for m in imported), imported
