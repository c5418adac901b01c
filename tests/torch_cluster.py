"""Shared drive of the cluster twins (``tests/test_torch_cluster*.py``,
``test_torch_forward.py``, ``test_torch_replication.py``,
``test_torch_placement.py``, ``test_torch_entity_sync.py``).

Two kinds of twin, over one loader (``test_torch_qos.py`` uses it too):

* **The port's copy of a JAX test module** (``port_tests(name)``): the
  source of ``tests/<name>.py`` with every ``sitewhere_tpu.`` import
  naming ``sitewhere_tpu_torch.``, its ``tests.test_*`` helpers taken
  from their port copies in turn, ``jax.device_get`` a conversion of the
  port's tensors to numpy (``jax_shim``), and ``device="cpu"`` added to
  every call that builds port state on a device (``DEVICE_CALLS``, made
  through ``on_cpu``: the port's entry points default to the card). Its
  test functions hold the port to the JAX test's own assertions: the
  property twins.
* **Answer twins** (``twin(monkeypatch, module, test, *args)``): the JAX
  test module's function and the port copy's run one after the other
  under a ``Recorder``, which logs what each package's cluster facade
  answered (query pages, device states, by-id lookups, searches, the
  federated scrape's family names) and every state tree the test reads
  back, with every rank's clock pinned to one instant
  (``pinned_clusters``) — the two logs must be equal.

Everything else stays the JAX test's: its cluster sizes, its seeds, its
waits (each with the JAX test's own deadline).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import pathlib
import re
import sys
import types

import numpy as np

from chip_smoke import CLUSTER_MASKED, masked

ROOT = pathlib.Path(__file__).resolve().parent

# calls that build port state on a device: each is made through
# ``on_cpu``, which adds ``device="cpu"`` unless the call names a device
DEVICE_CALLS = ("DistributedConfig", "recover_distributed", "restore_distributed",
                "Engine", "spawn_cluster_demo", "SiteWhereTpuInstance")
_CALL = re.compile(r"(?<![\w.])(" + "|".join(DEVICE_CALLS) + r")\(")


def on_cpu(fn):
    """``fn`` with ``device="cpu"`` as its default device."""
    def call(*args, **kw):
        return fn(*args, **{"device": "cpu", **kw})

    return call


def _add_device(text: str) -> str:
    def sub(m):
        line = text[text.rfind("\n", 0, m.start()) + 1:m.start()].lstrip()
        if line.startswith(("def ", "class ")):
            return m.group(0)
        return f"_on_cpu({m.group(1)})("

    return _CALL.sub(sub, text)


def port_source(text: str) -> str:
    """A JAX test module's source, pointed at the port."""
    text = text.replace("sitewhere_tpu.", "sitewhere_tpu_torch.")
    text = re.sub(r"from tests\.(test_(?:cluster|forward|replication|placement|"
                  r"entity_sync|cluster_reshard|cluster_observability))\b import",
                  r"from tests._port_\1 import", text)
    text = re.sub(r"^import jax$", "from tests.torch_cluster import jax_shim as jax",
                  text, flags=re.M)
    return ("from tests.torch_cluster import on_cpu as _on_cpu\n"
            + _add_device(text))


def port_tests(name: str) -> types.ModuleType:
    """The port's copy of ``tests/<name>.py`` (loaded once a process)."""
    key = f"tests._port_{name}"
    mod = sys.modules.get(key)
    if mod is not None:
        return mod
    path = ROOT / f"{name}.py"
    src = port_source(path.read_text())
    for dep in sorted(set(re.findall(r"from tests\._port_(\w+) import", src))):
        port_tests(dep)
    mod = types.ModuleType(key)
    mod.__file__ = str(path)
    sys.modules[key] = mod
    try:
        exec(compile(src, str(path), "exec"), mod.__dict__)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def to_numpy(x):
    """A port state tree (dataclasses of tensors) as numpy, like
    ``jax.device_get`` of the JAX one."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: to_numpy(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return x


jax_shim = types.SimpleNamespace(device_get=to_numpy,
                                 block_until_ready=lambda x: x)


def leaves_equal(a, b, name="state") -> None:
    """Two numpy trees (``to_numpy`` / ``jax.device_get``) leaf for leaf."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            leaves_equal(getattr(a, f.name), getattr(b, f.name),
                         f"{name}.{f.name}")
        return
    np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=name)


# ------------------------------------------------------------ answer twins
PIN_OFFSET_MS = 3_600_000       # the pinned clock: one hour past the base


def metric_families(text: str, engines) -> list[str]:
    """The families of an exposition (by its ``# TYPE`` lines) with a
    sample of one of ``engines`` (their ``engine=`` labels), and the
    fan-out's own ``swtpu_cluster_rank_up``. The registries are
    process-global: families of other tests' engines in the same process
    (and process-wide counters such as the scrape count, created by the
    first scrape of the process) differ between the packages, so only
    this test's engines are compared; the JAX package's XLA compile plane
    (``JAX_ONLY_FAMILIES``) is left out."""
    marks = tuple(f'engine="{e}"' for e in engines)
    fams, family = set(), None
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            family = ln.split()[2]
            if family == "swtpu_cluster_rank_up":
                fams.add(family)
        elif family is not None and not ln.startswith("#") and any(
                m in ln for m in marks):
            fams.add(family)
    return sorted(f for f in fams if not f.startswith(JAX_ONLY_FAMILIES))


# series only the JAX package exports: the XLA compile and retrace
# watchdog (the port keeps the memory half of the device plane)
JAX_ONLY_FAMILIES = ("swtpu_xla_",)


class Recorder(list):
    """What a package's cluster facades answered, in call order: entries
    ``(method, args, rank, answer)`` in plain form
    (``torch_parity.plain``; an exposition reduced to its family names),
    and in ``states`` every state tree the test read back through
    ``jax.device_get``."""

    METHODS = ("query_events", "get_event", "get_device", "get_device_state",
               "search_device_states", "list_devices", "list_assignments",
               "search_events", "query_events_batch", "cluster_metrics")

    def __init__(self, masked=()):
        super().__init__()
        self.masked = CLUSTER_MASKED | frozenset(masked)
        self.states: list = []
        self.engines: list[str] = []     # the ranks' engine labels
        self.reduce = {"cluster_metrics": lambda text: metric_families(
            text, self.engines)}

    def mask(self, x):
        return masked(x, self.masked)

    def device_get(self, fn):
        def recorded(tree):
            out = fn(tree)
            self.states.append(out)
            return out

        return recorded

    @contextlib.contextmanager
    def on(self, cluster_mod):
        from tests.torch_parity import plain

        cls = cluster_mod.ClusterEngine
        saved = {}
        rec = self

        def wrap(name, fn):
            reduce = self.reduce.get(name, lambda x: x)

            def recorded(self_, *a, **kw):
                out = fn(self_, *a, **kw)
                rec.append((name, plain(rec.mask(list(a))), plain(rec.mask(kw)),
                            self_.rank, plain(rec.mask(reduce(out)))))
                return out

            recorded.__wrapped__ = fn
            return recorded

        for name in self.METHODS:
            fn = cls.__dict__.get(name)
            if fn is not None:
                saved[name] = fn
                setattr(cls, name, wrap(name, fn))
        init = saved["__init__"] = cls.__init__

        def recorded_init(self_, *a, **kw):
            init(self_, *a, **kw)
            rec.engines.append(self_.local.metrics_label)

        cls.__init__ = recorded_init
        try:
            yield self
        finally:
            for name, fn in saved.items():
                setattr(cls, name, fn)


def pinned_clusters(monkeypatch, *packages) -> None:
    """Every cluster rank's clock (``cluster.EpochBase``) reads one fixed
    instant, ``PIN_OFFSET_MS`` past its base, in each package."""
    import importlib

    for root in packages:
        cm = importlib.import_module(f"{root}.parallel.cluster")
        base_cls = importlib.import_module(f"{root}.core.events").EpochBase

        class Pinned(base_cls):
            def now_ms(self) -> int:
                return PIN_OFFSET_MS

        monkeypatch.setattr(cm, "EpochBase", Pinned)


def twin(monkeypatch, module: str, test: str, *args, masked=()):
    """Run ``tests.<module>.<test>(*args)`` (the JAX package) and its port
    copy under a ``Recorder`` each: the two answer logs equal (and not
    empty), and the state trees each read back equal leaf for leaf.
    ``args`` may hold callables, each called once a side (fresh
    ``tmp_path`` directories); ``masked`` names answer keys that carry a
    host timing (a staleness in ms) or an unpinned clock. Returns the two
    recorders."""
    import importlib

    pinned_clusters(monkeypatch, "sitewhere_tpu", "sitewhere_tpu_torch")
    logs = []
    for side, root in ((importlib.import_module(f"tests.{module}"), "sitewhere_tpu"),
                       (port_tests(module), "sitewhere_tpu_torch")):
        # the process-global invocation counter starts each side at 1
        monkeypatch.setattr(importlib.import_module(f"{root}.commands.model"),
                            "_invocation_ids", itertools.count(1))
        rec = Recorder(masked)
        cm = importlib.import_module(f"{root}.parallel.cluster")
        jx = getattr(side, "jax", None)
        if jx is not None:
            monkeypatch.setattr(side, "jax", types.SimpleNamespace(
                device_get=rec.device_get(jx.device_get),
                block_until_ready=jx.block_until_ready))
        with rec.on(cm):
            getattr(side, test)(*[a() if callable(a) else a for a in args])
        logs.append(rec)
    jlog, tlog = logs
    assert jlog or jlog.states, f"{test}: no answer recorded"
    for i, (a, b) in enumerate(zip(jlog, tlog)):
        assert b == a, f"{test} answer {i}: port {b!r}\n  != JAX {a!r}"
    assert len(tlog) == len(jlog), (len(tlog), len(jlog))
    assert len(tlog.states) == len(jlog.states)
    for i, (a, b) in enumerate(zip(jlog.states, tlog.states)):
        leaves_equal(a, b, f"{test} state {i}")
    return jlog, tlog


def fresh_dirs(tmp_path):
    """A callable giving a new directory under ``tmp_path`` each call."""
    n = [0]

    def make():
        n[0] += 1
        d = tmp_path / f"side{n[0]}"
        d.mkdir()
        return d

    return make
