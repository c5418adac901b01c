"""A small HTTP/1.1 server and client on ``asyncio`` streams.

The REST gateway (``web/rest.py``) is written against the part of
``aiohttp.web`` that this module provides, under the same names:
``Application`` with middlewares, a router with ``{name}`` path templates,
``Request``, ``Response``, ``json_response``, ``middleware`` and the HTTP
exceptions it raises. The machine the port runs on has no ``aiohttp``, so
the gateway serves over this module, which imports nothing outside the
standard library. It answers as ``aiohttp.web`` 3.x does wherever a client
can see it:

* routes resolve by aiohttp's resource index: the candidates whose static
  prefix is the longest leading part of the path come first, and within
  one prefix the order of registration holds. A path that matches a
  resource under another method answers 405 with ``Allow`` (the methods
  sorted and comma-joined), a path that matches nothing 404;
* ``add_get`` registers HEAD on the same resource too; a HEAD answer
  carries the GET answer's headers and no body;
* ``match_info`` values are percent-decoded (``%2F`` included);
* middlewares run outermost first, around the error handlers as well;
* an HTTP exception raised by a handler is its response; any other
  exception answers 500 with aiohttp's body and closes the connection;
* a request body stays on the stream until the handler reads it, and is
  read at most up to aiohttp's default ``client_max_size`` (1 MiB): a
  declared ``Content-Length`` of that size or more answers 413 when the
  handler reads it, without reading the body, and a chunked body answers
  413 once that much has come. The unread rest of a body is read and
  dropped after the answer for up to ``LINGERING_TIME_S`` (aiohttp's
  ``lingering_time``), and the connection closes if it does not end by
  then;
* connections are kept alive (HTTP/1.1), bodies framed by
  ``Content-Length`` (chunked request bodies are accepted too); a
  connection that stays idle for ``KEEPALIVE_TIMEOUT_S`` between
  requests is closed.

``ClientSession`` is a matching client: keep-alive connections pooled per
host, ``request(method, url, json=, data=, headers=, params=)``.
"""

from __future__ import annotations

import asyncio
import email.utils
import json as _json
import logging
import re
import sys
import urllib.parse
from http import HTTPStatus
from typing import Any, AsyncIterator, Callable, Iterable, Iterator

_MAX_LINE = 1 << 16
_PIECE = 1 << 16                # a body is read in pieces of at most this
CLIENT_MAX_SIZE = 1024 ** 2     # aiohttp.web's default client_max_size
KEEPALIVE_TIMEOUT_S = 75.0      # aiohttp.web.run_app's keepalive_timeout
LINGERING_TIME_S = 10.0         # aiohttp's lingering_time
logger = logging.getLogger(__name__)
_SERVER = f"Python/{sys.version_info[0]}.{sys.version_info[1]} sitewhere-tpu-torch"


def _reason(status: int) -> str:
    try:
        return HTTPStatus(status).phrase
    except ValueError:
        return ""


class MultiDict:
    """Ordered (key, value) pairs, a key may repeat: the query string.
    ``get`` and ``[]`` give a key's first value, ``getall`` every one."""

    @staticmethod
    def _fold(key: str) -> str:
        return key

    def __init__(self, items: Iterable[tuple[str, str]] | dict | None = None):
        pairs = items.items() if isinstance(items, dict) else items or ()
        self._items = [(str(k), str(v)) for k, v in pairs]

    def getall(self, key: str, default=...):
        k = self._fold(key)
        out = [v for name, v in self._items if self._fold(name) == k]
        if out or default is not ...:
            return out or default
        raise KeyError(key)

    def get(self, key: str, default=None):
        return self.getall(key, [default])[0]

    def __getitem__(self, key: str) -> str:
        return self.getall(key)[0]

    def __setitem__(self, key: str, value) -> None:
        k = self._fold(key)
        self._items = [(n, v) for n, v in self._items if self._fold(n) != k]
        self._items.append((key, str(value)))

    def setdefault(self, key: str, value) -> str:
        if key not in self:
            self[key] = value
        return self[key]

    def add(self, key: str, value) -> None:
        self._items.append((key, str(value)))

    def __contains__(self, key) -> bool:
        return isinstance(key, str) and bool(self.getall(key, []))

    def __iter__(self) -> Iterator[str]:
        return (k for k, _ in self._items)

    def __len__(self) -> int:
        return len(self._items)

    def items(self) -> list[tuple[str, str]]:
        return list(self._items)


class CIMultiDict(MultiDict):
    """Headers: a ``MultiDict`` whose keys compare case-insensitively."""

    @staticmethod
    def _fold(key: str) -> str:
        return key.lower()


# ---------------------------------------------------------------- responses
class Response:
    """An answer: status, headers, and a body given as ``text`` (encoded
    utf-8, ``text/plain`` unless ``content_type`` says otherwise, with the
    charset named) or as ``body`` bytes (the content type as given)."""

    def __init__(self, *, body: bytes | None = None, status: int = 200,
                 reason: str | None = None, text: str | None = None,
                 headers=None, content_type: str | None = None):
        if body is not None and text is not None:
            raise ValueError("body and text are not allowed together")
        self.status = int(status)
        self.reason = reason or _reason(self.status)
        self.headers = CIMultiDict(headers)
        self.body = body
        self.force_close = False
        if text is not None:
            self.headers["Content-Type"] = f"{content_type or 'text/plain'}; charset=utf-8"
            self.body = text.encode("utf-8")
        elif content_type is not None:
            self.headers["Content-Type"] = content_type


def json_response(data: Any = None, *, status: int = 200, headers=None,
                  dumps: Callable[[Any], str] = _json.dumps) -> Response:
    return Response(text=dumps(data), status=status, headers=headers,
                    content_type="application/json")


class HTTPException(Exception):
    """An HTTP answer raised by a handler; the server sends ``response``."""

    status_code = 500

    def __init__(self, *, text: str | None = None):
        reason = _reason(self.status_code)
        self.response = Response(status=self.status_code,
                                 text=f"{self.status_code}: {reason}"
                                 if text is None else text)
        super().__init__(reason)


class HTTPForbidden(HTTPException):
    status_code = 403


class HTTPNotFound(HTTPException):
    status_code = 404


class HTTPMethodNotAllowed(HTTPException):
    status_code = 405

    def __init__(self, allowed_methods: Iterable[str]):
        super().__init__()
        self.response.headers["Allow"] = ",".join(sorted(allowed_methods))


class HTTPRequestEntityTooLarge(HTTPException):
    status_code = 413

    def __init__(self, max_size: int, actual_size: int):
        super().__init__(text=f"Maximum request body size {max_size} exceeded, "
                              f"actual body size {actual_size}")


def middleware(fn):
    """Marks a ``(request, handler) -> response`` coroutine as a middleware
    (aiohttp's new-style marker; every middleware here is new-style)."""
    fn.__middleware_version__ = 1
    return fn


# ------------------------------------------------------------------ request
class Request:
    """One parsed request. ``headers`` is case-insensitive, ``query`` a
    multi-dict, ``match_info`` the decoded path variables; item access
    stores per-request values (``request["user"]``)."""

    def __init__(self, method: str, raw_path: str, query_string: str,
                 headers: CIMultiDict, pieces: AsyncIterator[bytes] | None = None):
        self.method = method.upper()
        self.path = urllib.parse.unquote(raw_path)
        self.path_safe = _path_safe(raw_path)
        self.query = MultiDict(urllib.parse.parse_qsl(query_string,
                                                      keep_blank_values=True))
        self.headers = headers
        self.match_info: dict[str, str] = {}
        self._pieces = pieces       # the body still on the stream
        self._body: bytes | None = None
        self._state: dict[str, Any] = {}

    @property
    def content_length(self) -> int | None:
        v = self.headers.get("Content-Length")
        return None if v is None else int(v)

    @property
    def can_read_body(self) -> bool:
        return self._pieces is not None and self._body is None

    async def read(self) -> bytes:
        """The whole body, read from the stream on the first call. A body
        of ``CLIENT_MAX_SIZE`` bytes or more raises 413 (as aiohttp's
        ``>=``): a declared length before any of it is read, a chunked
        body as soon as that much has come."""
        if self._body is None:
            size = self.content_length
            if size is not None and size >= CLIENT_MAX_SIZE:
                raise HTTPRequestEntityTooLarge(CLIENT_MAX_SIZE, size)
            out = bytearray()
            if self._pieces is not None:
                async for piece in self._pieces:
                    out += piece
                    if len(out) >= CLIENT_MAX_SIZE:
                        raise HTTPRequestEntityTooLarge(CLIENT_MAX_SIZE, len(out))
            self._body = bytes(out)
        return self._body

    async def text(self) -> str:
        return (await self.read()).decode("utf-8")

    async def json(self, *, loads: Callable[[str], Any] = _json.loads) -> Any:
        return loads(await self.text())

    def __getitem__(self, key: str):
        return self._state[key]

    def __setitem__(self, key: str, value) -> None:
        self._state[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._state

    def get(self, key: str, default=None):
        return self._state.get(key, default)


def _path_safe(raw: str) -> str:
    """The path decoded except ``%2F`` and ``%25`` (yarl's ``path_safe``):
    a decoded slash cannot split a path variable."""
    parts = re.split(r"(%2[fF]|%25)", raw)
    return "".join(p.upper() if i % 2 else urllib.parse.unquote(p)
                   for i, p in enumerate(parts))


def _unquote_path_safe(value: str) -> str:
    if "%" not in value:
        return value
    return value.replace("%2F", "/").replace("%25", "%")


# ------------------------------------------------------------------- router
_DYN = re.compile(r"\{(?P<var>[_a-zA-Z][_a-zA-Z0-9]*)\}")
_ROUTE = re.compile(r"(\{[_a-zA-Z][^{}]*(?:\{[^{}]*\}[^{}]*)*\})")


class Route:
    def __init__(self, method: str, handler, resource: "Resource"):
        self.method = method
        self.handler = handler
        self.resource = resource


class Resource:
    def __init__(self, path: str):
        self.path = path
        self.routes: dict[str, Route] = {}
        if not _ROUTE.search(path):
            self.canonical = path
            self._pattern = None
        else:
            pattern = ""
            for part in _ROUTE.split(path):
                m = _DYN.fullmatch(part)
                if m:
                    pattern += f"(?P<{m.group('var')}>[^{{}}/]+)"
                elif "{" in part or "}" in part:
                    raise ValueError(f"Invalid path '{path}'['{part}']")
                else:
                    pattern += re.escape(part)
            self.canonical = path
            self._pattern = re.compile(pattern)

    def get_info(self) -> dict:
        if self._pattern is None:
            return {"path": self.path}
        return {"formatter": self.canonical, "pattern": self._pattern}

    def index_key(self) -> str:
        key = self.canonical
        if "{" in key:
            key = key.partition("{")[0].rpartition("/")[0]
        return key.rstrip("/") or "/"

    def match(self, path_safe: str) -> dict[str, str] | None:
        if self._pattern is None:
            return {} if path_safe == self.path else None
        m = self._pattern.fullmatch(path_safe)
        if m is None:
            return None
        return {k: _unquote_path_safe(v) for k, v in m.groupdict().items()}

    def add_route(self, method: str, handler) -> Route:
        method = method.upper()
        if method in self.routes:
            raise RuntimeError(
                f"Added route will never be executed, method {method} is "
                "already registered")
        route = Route(method, handler, self)
        self.routes[method] = route
        return route


class Router:
    def __init__(self):
        self._resources: list[Resource] = []
        self._index: dict[str, list[Resource]] = {}

    def add_resource(self, path: str) -> Resource:
        if path and not path.startswith("/"):
            raise ValueError("path should be started with / or be empty")
        if self._resources and self._resources[-1].path == path:
            return self._resources[-1]
        res = Resource(path)
        self._resources.append(res)
        self._index.setdefault(res.index_key(), []).append(res)
        return res

    def add_route(self, method: str, path: str, handler) -> Route:
        return self.add_resource(path).add_route(method, handler)

    def add_get(self, path: str, handler) -> Route:
        res = self.add_resource(path)
        res.add_route("HEAD", handler)
        return res.add_route("GET", handler)

    def add_post(self, path: str, handler) -> Route:
        return self.add_route("POST", path, handler)

    def add_put(self, path: str, handler) -> Route:
        return self.add_route("PUT", path, handler)

    def add_delete(self, path: str, handler) -> Route:
        return self.add_route("DELETE", path, handler)

    def routes(self) -> list[Route]:
        return [r for res in self._resources for r in res.routes.values()]

    def resolve(self, method: str, path_safe: str):
        """``(handler, match_info)``; the handler of a miss raises the 404
        or the 405."""
        allowed: set[str] = set()
        part = path_safe
        while part:
            for res in self._index.get(part, ()):
                info = res.match(path_safe)
                if info is None:
                    continue
                route = res.routes.get(method)
                if route is not None:
                    return route.handler, info
                allowed |= set(res.routes)
            if part == "/":
                break
            part = part.rpartition("/")[0] or "/"
        exc = HTTPMethodNotAllowed(allowed) if allowed else HTTPNotFound()

        async def fail(request):
            raise exc

        return fail, {}


class Application:
    def __init__(self, *, middlewares: Iterable = ()):
        self.router = Router()
        self.middlewares = list(middlewares)

    async def handle(self, request: Request) -> Response:
        """The answer to ``request``: route, middlewares (the first one
        outermost), HTTP exceptions rendered; any other exception
        propagates to the connection, which answers 500."""
        handler, info = self.router.resolve(request.method, request.path_safe)
        request.match_info = info
        for mw in reversed(self.middlewares):
            handler = _bind(mw, handler)
        try:
            return await handler(request)
        except HTTPException as e:
            return e.response


def _bind(mw, handler):
    async def call(request):
        return await mw(request, handler)

    return call


# ------------------------------------------------------------------- server
class BadRequest(Exception):
    pass


async def _read_head(reader: asyncio.StreamReader) -> list[str] | None:
    """The start line and header lines of one message (None at a clean
    end of stream)."""
    lines: list[str] = []
    total = 0
    while True:
        line = await reader.readline()
        if not line:
            if lines:
                raise BadRequest("connection closed inside a message head")
            return None
        total += len(line)
        if total > _MAX_LINE:
            raise BadRequest("message head too long")
        line = line.rstrip(b"\r\n")
        if not line:
            if not lines:       # tolerate blank lines between messages
                continue
            return lines
        lines.append(line.decode("latin-1"))


def _parse_headers(lines: list[str]) -> CIMultiDict:
    h = CIMultiDict()
    for line in lines:
        name, sep, value = line.partition(":")
        if not sep:
            raise BadRequest(f"bad header line {line!r}")
        h.add(name.strip(), value.strip())
    return h


def _chunked(headers: CIMultiDict) -> bool:
    return "chunked" in headers.get("Transfer-Encoding", "").lower()


def _has_body(headers: CIMultiDict) -> bool:
    """Whether a request with ``headers`` carries a body (a bad
    ``Content-Length`` is a bad request)."""
    if _chunked(headers):
        return True
    n = headers.get("Content-Length")
    if n is None:
        return False
    if not n.isdigit():
        raise BadRequest(f"bad Content-Length {n!r}")
    return int(n) > 0


async def _body_pieces(reader: asyncio.StreamReader, headers: CIMultiDict,
                       until_eof: bool = False) -> AsyncIterator[bytes]:
    """The body of one message as it arrives, in pieces of at most
    ``_PIECE`` bytes: chunked, framed by ``Content-Length``, or (with
    ``until_eof``) up to the end of the stream."""
    if _chunked(headers):
        while True:
            size_line = await reader.readline()
            size = int(size_line.split(b";", 1)[0].strip() or b"0", 16)
            if size == 0:
                while (await reader.readline()).strip():
                    pass        # trailers
                return
            while size:
                piece = await reader.readexactly(min(size, _PIECE))
                size -= len(piece)
                yield piece
            await reader.readexactly(2)
    n = headers.get("Content-Length")
    if n is not None:
        left = int(n)
        while left:
            piece = await reader.readexactly(min(left, _PIECE))
            left -= len(piece)
            yield piece
    elif until_eof:
        while piece := await reader.read(_PIECE):
            yield piece


async def _read_body(reader: asyncio.StreamReader, headers: CIMultiDict,
                     until_eof: bool = False) -> bytes:
    return b"".join([p async for p in _body_pieces(reader, headers, until_eof)])


async def _drop(pieces: AsyncIterator[bytes]) -> None:
    async for _ in pieces:
        pass


def _http_date() -> str:
    return email.utils.formatdate(usegmt=True)


def _encode_response(resp: Response, head_only: bool, close: bool) -> bytes:
    body = resp.body or b""
    lines = [f"HTTP/1.1 {resp.status} {resp.reason}"]
    for k, v in resp.headers.items():
        if k.lower() not in ("content-length", "connection", "date", "server",
                             "transfer-encoding"):
            lines.append(f"{k}: {v}")
    lines.append(f"Content-Length: {len(body)}")
    lines.append(f"Date: {_http_date()}")
    lines.append(f"Server: {_SERVER}")
    if close:
        lines.append("Connection: close")
    data = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
    return data if head_only else data + body


def _internal_error() -> Response:
    title = "500 Internal Server Error"
    resp = Response(status=500, text=title + "\n\n" + HTTPStatus(500).description)
    resp.force_close = True
    return resp


class Server:
    """A listening server: ``port`` is the bound port; ``close()`` stops
    listening and ends every connection. A connection idle for
    ``KEEPALIVE_TIMEOUT_S`` between requests is closed."""

    def __init__(self, app: Application):
        self.app = app
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[asyncio.Task] = set()
        self.port: int | None = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> "Server":
        self._server = await asyncio.start_server(self._connection, host, port,
                                                  limit=_MAX_LINE)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while True:
                try:
                    async with asyncio.timeout(KEEPALIVE_TIMEOUT_S):
                        head = await _read_head(reader)
                    if head is None:
                        return
                    method, target, version = head[0].split(" ", 2)
                    headers = _parse_headers(head[1:])
                    pieces = _body_pieces(reader, headers) if _has_body(headers) else None
                except TimeoutError:
                    return
                except (BadRequest, ValueError, asyncio.IncompleteReadError):
                    resp = Response(status=400, text="400: Bad Request")
                    writer.write(_encode_response(resp, False, True))
                    await writer.drain()
                    return
                raw_path, _, qs = target.partition("?")
                req = Request(method, raw_path, qs, headers, pieces)
                try:
                    resp = await self.app.handle(req)
                except Exception:
                    logger.exception("Error handling request")
                    resp = _internal_error()
                conn = headers.get("Connection", "").lower()
                close = (resp.force_close or conn == "close"
                         or (version == "HTTP/1.0" and conn != "keep-alive"))
                writer.write(_encode_response(resp, req.method == "HEAD", close))
                await writer.drain()
                if close:
                    return
                if req.can_read_body:
                    # the body the handler left unread (or stopped reading
                    # at the size limit): read and dropped, as aiohttp's
                    # lingering read, before the next request's head
                    try:
                        async with asyncio.timeout(LINGERING_TIME_S):
                            await _drop(pieces)
                    except (TimeoutError, ValueError, asyncio.IncompleteReadError):
                        return
        except ConnectionError:
            pass
        finally:
            self._conns.discard(task)
            writer.close()

    async def close(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for t in list(self._conns):
            t.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None


async def serve(app: Application, host: str = "127.0.0.1",
                port: int = 0) -> Server:
    """Start serving ``app``; the returned server's ``port`` is bound."""
    return await Server(app).start(host, port)


# ------------------------------------------------------------------- client
class ClientResponse:
    def __init__(self, status: int, headers: CIMultiDict, body: bytes):
        self.status = status
        self.headers = headers
        self.body = body

    async def json(self) -> Any:
        return _json.loads(self.body)


class ClientSession:
    """Keep-alive HTTP/1.1 client: idle connections are pooled per
    ``(host, port)`` and reused; one request at a time a connection."""

    def __init__(self):
        self._idle: dict[tuple[str, int], list] = {}

    async def request(self, method: str, url: str, *, json: Any = None,
                      data: bytes | str | None = None,
                      headers: dict | None = None,
                      params: dict | None = None) -> ClientResponse:
        u = urllib.parse.urlsplit(url)
        if u.scheme != "http":
            raise ValueError(f"only http:// URLs are served: {url}")
        host, port = u.hostname, u.port or 80
        target = u.path or "/"
        query = u.query
        if params:
            extra = urllib.parse.urlencode(params)
            query = f"{query}&{extra}" if query else extra
        if query:
            target += "?" + query
        h = CIMultiDict(headers)
        if json is not None:
            body = _json.dumps(json).encode()
            h.setdefault("Content-Type", "application/json")
        elif data is not None:
            body = data.encode() if isinstance(data, str) else bytes(data)
        else:
            body = b""
        h["Host"] = f"{host}:{port}"
        h["Content-Length"] = str(len(body))
        head = "\r\n".join([f"{method.upper()} {target} HTTP/1.1",
                            *(f"{k}: {v}" for k, v in h.items())])
        msg = (head + "\r\n\r\n").encode("latin-1") + body
        pool = self._idle.setdefault((host, port), [])
        while True:
            reused = bool(pool)
            reader, writer = (pool.pop() if reused else
                              await asyncio.open_connection(host, port,
                                                            limit=_MAX_LINE))
            try:
                writer.write(msg)
                await writer.drain()
                lines = await _read_head(reader)
                if lines is None:
                    raise ConnectionResetError("connection closed")
                break
            except (ConnectionError, BadRequest):
                writer.close()
                if not reused:
                    raise
        status = lines[0].split(" ", 2)[1]
        rh = _parse_headers(lines[1:])
        close = rh.get("Connection", "").lower() == "close"
        if method.upper() == "HEAD" or int(status) in (204, 304):
            rbody = b""
        else:
            rbody = await _read_body(reader, rh, until_eof=close)
        if close:
            writer.close()
        else:
            pool.append((reader, writer))
        return ClientResponse(int(status), rh, rbody)

    async def get(self, url: str, **kw) -> ClientResponse:
        return await self.request("GET", url, **kw)

    async def post(self, url: str, **kw) -> ClientResponse:
        return await self.request("POST", url, **kw)

    async def close(self) -> None:
        for conns in self._idle.values():
            for _, writer in conns:
                writer.close()
        self._idle.clear()

    async def __aenter__(self) -> "ClientSession":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

