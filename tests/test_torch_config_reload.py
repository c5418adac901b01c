"""Twins of ``tests/test_config_reload.py``: the tenant config's hot
reload on the JAX instance and on the port's (``device="cpu"``). Each case
runs the JAX test's steps and assertions on both packages, records what it
observed (``note``) and, over REST, every answer; the two records must be
the same, and so must the engines."""

import asyncio
import base64
import json
import os

import pytest

from tests.torch_servers import (BOTH, compare_engines, compare_logs,
                                 make_instance, mask, pin_servers, rest_side)
from tests.torch_parity import plain

SCRIPT = """
from sitewhere_tpu.ingest.requests import DecodedRequest, RequestType

def decode(payload, metadata):
    return [DecodedRequest(type=RequestType.DEVICE_MEASUREMENT,
                           device_token=payload.decode(),
                           measurements={"swapped": 42.0})]
"""

V1_CFG = {
    "eventSources": [
        {"id": "in", "type": "inmemory", "decoder": {"type": "json"}},
    ],
}


def json_payload(token: str) -> bytes:
    return json.dumps({"deviceToken": token, "type": "DeviceMeasurement",
                       "request": {"name": "t", "value": 7.0}}).encode()


def scripted_cfg(script_path) -> dict:
    return {
        "eventSources": [
            {"id": "in", "type": "inmemory",
             "decoder": {"type": "scripted", "script": str(script_path)}},
        ],
    }


def write_script(P, d) -> str:
    """The decoder script, naming ``P``'s package, in ``d/<package>``;
    the path a config names (the same relative name on both sides)."""
    d = d / P.root
    d.mkdir(exist_ok=True)
    (d / "dec.py").write_text(SCRIPT.replace("sitewhere_tpu.", f"{P.root}."))
    return str(d / "dec.py")


class Run:
    """One package's side of a case: its config module, a loop, and what
    the case observed."""

    def __init__(self, P):
        self.P = P
        self.cfg = P.mod("config")
        self.loop = asyncio.new_event_loop()
        self.notes: list = []

    def note(self, *values) -> None:
        self.notes.append(mask(plain(list(values))))

    def reload(self, inst, cfg, **kw):
        return self.loop.run_until_complete(
            self.cfg.reload_tenant_config(inst, cfg, **kw))


@pytest.fixture
def twin(monkeypatch):
    """``twin(case)``: ``case(run) -> instance`` on each package; the notes
    equal, the engines leaf for leaf."""
    pin_servers(monkeypatch)

    def go(case):
        runs, insts = [], []
        for P in BOTH:
            run = Run(P)
            try:
                insts.append(case(run))
            finally:
                run.loop.close()
            runs.append(run)
        assert runs[1].notes == runs[0].notes
        compare_engines(insts[0].engine, insts[1].engine)

    return go


def state_of(inst, token):
    inst.engine.flush()
    return inst.engine.get_device_state(token)


def test_reload_swaps_decoder_live(twin, tmp_path):
    def case(run):
        inst = make_instance(run.P)
        run.cfg.apply_tenant_config(inst, V1_CFG)
        inst.event_sources.sources["in"].receivers[0].submit(json_payload("hr-1"))
        st = state_of(inst, "hr-1")
        assert st["measurements"]["t"]["value"] == 7.0
        run.note(st)
        summary = run.reload(inst, scripted_cfg(write_script(run.P, tmp_path)))
        run.note(summary)
        # the source id survived the swap; the NEXT ingest decodes via script
        src = inst.event_sources.sources["in"]
        src.receivers[0].submit(b"hr-2")
        st = state_of(inst, "hr-2")
        assert st["measurements"]["swapped"]["value"] == 42.0
        # exactly one source registered (old one detached)
        assert list(inst.event_sources.sources) == ["in"]
        assert sum(1 for c in inst.event_sources.children) == 1
        run.note(st, list(inst.event_sources.sources))
        return inst

    twin(case)


def test_reload_validates_before_teardown(twin):
    def case(run):
        inst = make_instance(run.P)
        run.cfg.apply_tenant_config(inst, V1_CFG)
        with pytest.raises(run.cfg.ConfigError) as ei:
            run.reload(inst, {"eventSources": [{"id": "in", "type": "bogus"}]})
        run.note(str(ei.value))
        # the old graph is still serving
        inst.event_sources.sources["in"].receivers[0].submit(json_payload("hr-3"))
        st = state_of(inst, "hr-3")
        assert st is not None
        run.note(st)
        return inst

    twin(case)


def test_reload_over_rest_and_get_configuration(twin, tmp_path):
    logs = []

    def case(run):
        inst = make_instance(run.P)
        run.cfg.apply_tenant_config(inst, V1_CFG)
        script = write_script(run.P, tmp_path)
        with rest_side(run.P, inst=inst) as S:
            url = ("/api/microservices/event-sources/tenants/default"
                   "/configuration")
            status, body = S.call("GET", url)
            assert status == 200
            assert body["configuration"] == V1_CFG
            # live hot-reload over POST (the script path differs by package)
            status, body = S.call("POST", url, {
                "configuration": scripted_cfg(script)},
                keep=lambda b: b["summary"])
            assert status == 200
            assert body["summary"]["eventSources"] == ["in"]
            # bad config -> 400, old graph intact
            status, _ = S.call("POST", url, {"configuration": {"eventSources": [
                {"id": "in", "type": "bogus"}]}})
            assert status == 400
            status, body = S.call("GET", url, keep=lambda b: sorted(b))
            assert body["configuration"] == scripted_cfg(script)
        logs.append(S.log)
        # decoder actually swapped
        inst.event_sources.sources["in"].receivers[0].submit(b"hr-4")
        st = state_of(inst, "hr-4")
        assert st["measurements"]["swapped"]["value"] == 42.0
        run.note(st)
        return inst

    twin(case)
    compare_logs(*logs)


def test_config_file_watcher(twin, tmp_path):
    def case(run):
        d = tmp_path / run.P.root
        inst = make_instance(run.P)
        script = write_script(run.P, tmp_path)
        cfg_file = d / "tenant.json"
        cfg_file.write_text(json.dumps(V1_CFG))
        run.cfg.apply_tenant_config(inst, cfg_file)
        watcher = run.cfg.TenantConfigWatcher(inst, cfg_file)

        async def drive():
            # first check adopts the already-applied startup config silently
            assert await watcher.check() is False
            cfg_file.write_text(json.dumps(scripted_cfg(script)))
            os.utime(cfg_file)   # defeat coarse mtime granularity
            assert await watcher.check() is True
            assert await watcher.check() is False   # no change -> no reload

        run.loop.run_until_complete(drive())
        inst.event_sources.sources["in"].receivers[0].submit(b"hr-5")
        st = state_of(inst, "hr-5")
        assert st["measurements"]["swapped"]["value"] == 42.0
        run.note(st)
        return inst

    twin(case)


def test_reload_is_tenant_scoped(twin):
    """Reloading tenant B must not clobber or tear down tenant A's
    recorded graph."""
    def case(run):
        inst = make_instance(run.P)
        run.cfg.apply_tenant_config(inst, V1_CFG, tenant="default")
        run.reload(inst, {"eventSources": [{"id": "acme-in", "type": "inmemory",
                                            "decoder": {"type": "json"}}]},
                   tenant="acme")
        # both graphs live, both records present and distinct
        assert set(inst.event_sources.sources) == {"in", "acme-in"}
        assert inst.tenant_configs["default"]["summary"]["eventSources"] == ["in"]
        assert inst.tenant_configs["acme"]["summary"]["eventSources"] == ["acme-in"]
        run.note(inst.tenant_configs)
        # reloading default touches only default's components
        run.reload(inst, V1_CFG, tenant="default")
        assert set(inst.event_sources.sources) == {"in", "acme-in"}
        run.note(inst.tenant_configs, sorted(inst.event_sources.sources))
        return inst

    twin(case)


def test_reload_rejects_id_collisions_before_teardown(twin):
    def case(run):
        inst = make_instance(run.P)
        run.cfg.apply_tenant_config(inst, V1_CFG, tenant="default")
        # duplicate ids inside one config
        with pytest.raises(run.cfg.ConfigError, match="duplicate") as ei:
            run.reload(inst, {"eventSources": [
                {"id": "x", "type": "inmemory", "decoder": {"type": "json"}},
                {"id": "x", "type": "inmemory", "decoder": {"type": "json"}},
            ]}, tenant="acme")
        run.note(str(ei.value))
        # collision with ANOTHER tenant's live source
        with pytest.raises(run.cfg.ConfigError, match="already in use") as ei:
            run.reload(inst, {"eventSources": [{"id": "in", "type": "inmemory",
                                                "decoder": {"type": "json"}}]},
                       tenant="acme")
        run.note(str(ei.value))
        # default's graph untouched by either rejection
        assert set(inst.event_sources.sources) == {"in"}
        inst.event_sources.sources["in"].receivers[0].submit(json_payload("tc-1"))
        st = state_of(inst, "tc-1")
        assert st is not None
        run.note(st)
        return inst

    twin(case)


def test_reload_teardown_detaches_destinations(twin):
    def case(run):
        inst = make_instance(run.P)
        cfg = dict(V1_CFG)
        cfg["commandRouting"] = {
            "destinations": [{"id": "d1", "type": "local",
                              "encoder": {"type": "json"}}]}
        run.note(run.cfg.apply_tenant_config(inst, cfg))
        n_children = len(inst.commands.children)
        for _ in range(3):
            run.note(run.reload(inst, cfg))
        # children must not accumulate across reloads
        assert len(inst.commands.children) == n_children
        assert list(inst.commands.destinations) == ["d1"]
        run.note(n_children, [c.name for c in inst.commands.children])
        return inst

    twin(case)


def test_scripting_and_config_endpoints_require_admin(twin):
    logs = []

    def case(run):
        inst = make_instance(run.P)
        run.cfg.apply_tenant_config(inst, V1_CFG)
        inst.users.create_user("viewer", "pw", roles=["user"])
        with rest_side(run.P, inst=inst) as S:
            basic = base64.b64encode(b"viewer:pw").decode()
            status, body = S.call("GET", "/api/authapi/jwt",
                                  headers={"Authorization": f"Basic {basic}"})
            h = {"Authorization": f"Bearer {body['token']}"}
            sb = "/api/microservices/event-sources/tenants/default/scripting"
            status, _ = S.call("POST", f"{sb}/scripts", {
                "id": "evil", "content": "import os"}, headers=h)
            assert status == 403
            status, _ = S.call("GET", f"{sb}/scripts", headers=h)
            assert status == 403
            status, _ = S.call(
                "POST", "/api/microservices/event-sources/tenants/default"
                "/configuration", {"configuration": V1_CFG}, headers=h)
            assert status == 403
        logs.append(S.log)
        return inst

    twin(case)
    compare_logs(*logs)


def test_reload_retires_stale_router(twin):
    """Dropping commandRouting from a tenant's config must not leave the
    old router aimed at torn-down destinations."""
    def case(run):
        NoOpCommandRouter = run.P.mod("commands.routing").NoOpCommandRouter
        inst = make_instance(run.P)
        cfg = dict(V1_CFG)
        cfg["commandRouting"] = {
            "router": {"type": "single-choice", "destination": "d1"},
            "destinations": [{"id": "d1", "type": "local",
                              "encoder": {"type": "json"}}]}
        run.cfg.apply_tenant_config(inst, cfg)
        installed = inst.commands.router
        # new config without commandRouting: destinations AND router retire
        run.note(run.reload(inst, V1_CFG))
        assert inst.commands.destinations == {}
        assert isinstance(inst.commands.router, NoOpCommandRouter)
        assert inst.commands.router is not installed
        # a config WITH routing installs its own router again
        run.note(run.reload(inst, cfg))
        assert not isinstance(inst.commands.router, NoOpCommandRouter)
        assert list(inst.commands.destinations) == ["d1"]
        run.note(type(inst.commands.router).__name__)
        return inst

    twin(case)
