"""Scripting component: user script hooks loaded from files (port of
``sitewhere_tpu/utils/scripting.py``, a copy: plain Python).

The reference customizes pipeline behavior with Groovy scripts managed by
its ScriptingComponent/ScriptingUtils (scripted event decoders,
deduplicators, command routers, connector filters), shipped as templates
in script-templates/ with a documented binding contract.

Here scripts are plain Python files. A script exposes one or more named
functions (the binding contract is the function signature); the manager
compiles the file once and caches it by (path, mtime), so edits
hot-reload, and hands ``ScriptHandle``s to the scripted components
(``ingest/decoders.ScriptedDecoder``, ``ingest/dedup.ScriptedDeduplicator``).
``ScriptManagement`` keeps versioned tenant scripts on disk.
"""

from __future__ import annotations

import pathlib
import threading
from typing import Any, Callable


class ScriptError(ValueError):
    pass


class ScriptHandle:
    """One callable resolved from a script file; re-resolves on reload."""

    def __init__(self, manager: "ScriptManager", path: pathlib.Path,
                 function: str):
        self._manager = manager
        self._path = path
        self._function = function

    @property
    def name(self) -> str:
        return f"{self._path.name}:{self._function}"

    def __call__(self, *args, **kwargs):
        fn = self._manager._resolve(self._path, self._function)
        return fn(*args, **kwargs)


class ScriptManager:
    """Loads, caches, and hot-reloads script files (ScriptingComponent +
    ScriptingUtils analog)."""

    def __init__(self, root: str | pathlib.Path | None = None):
        self.root = pathlib.Path(root) if root is not None else None
        self._lock = threading.Lock()
        # path -> (mtime, namespace)
        self._cache: dict[pathlib.Path, tuple[float, dict[str, Any]]] = {}

    def _path_of(self, script: str | pathlib.Path) -> pathlib.Path:
        p = pathlib.Path(script)
        if not p.is_absolute() and self.root is not None:
            p = self.root / p
        return p

    def _load(self, path: pathlib.Path) -> dict[str, Any]:
        try:
            mtime = path.stat().st_mtime
        except OSError as e:
            raise ScriptError(f"script {path} not readable: {e}") from e
        with self._lock:
            cached = self._cache.get(path)
        if cached is not None and cached[0] == mtime:
            return cached[1]
        # compile/exec OUTSIDE the lock: scripts may themselves resolve other
        # scripts through this manager at import time (composite scripts),
        # and a slow load must not stall every other scripted hook. Two
        # racing loads of the same file both succeed; last one wins.
        ns: dict[str, Any] = {"__file__": str(path), "__name__": path.stem}
        code = compile(path.read_text(), str(path), "exec")
        exec(code, ns)
        with self._lock:
            self._cache[path] = (mtime, ns)
        return ns

    def _resolve(self, path: pathlib.Path, function: str) -> Callable:
        ns = self._load(path)
        fn = ns.get(function)
        if not callable(fn):
            raise ScriptError(
                f"script {path} does not define callable {function!r} "
                f"(defines: {sorted(k for k, v in ns.items() if callable(v) and not k.startswith('_'))})")
        return fn

    def handle(self, script: str | pathlib.Path,
               function: str) -> ScriptHandle:
        """Resolve (and eagerly validate) a script function."""
        path = self._path_of(script)
        self._resolve(path, function)   # fail fast at config time
        return ScriptHandle(self, path, function)

    def list_scripts(self) -> list[str]:
        """Script files under the template root (script-templates analog)."""
        if self.root is None or not self.root.exists():
            return []
        return sorted(str(p.relative_to(self.root))
                      for p in self.root.rglob("*.py"))


# module-level default manager: a bare {"script": "...", "function": "..."}
# spec resolves through it (the tenant config's "scripted" component types)
DEFAULT_MANAGER = ScriptManager()


def script_handle(spec: dict, default_function: str,
                  manager: ScriptManager | None = None) -> ScriptHandle:
    """Build a handle from a ``{script, function?}`` config spec — the
    shared plumbing of every scripted component type of a tenant config."""
    if "script" not in spec:
        raise ScriptError("scripted component requires a 'script' path")
    mgr = manager or DEFAULT_MANAGER
    return mgr.handle(spec["script"], spec.get("function", default_function))


# --------------------------------------------------------------------------
# Versioned tenant script management (reference: IScriptManagement consumed
# by Instance.java's /microservices/{id}/tenants/{token}/scripting/* REST
# family — script CRUD, per-version content, clone, activate; versions were
# kept in ZooKeeper, here on disk).
# --------------------------------------------------------------------------

import json as _json
import shutil
import time as _time


class ScriptManagement:
    """Disk-persisted, versioned script store scoped by (functional area,
    tenant) — the identifier/tenantToken pair of the reference's paths.

    Layout::

        root/{identifier}/{tenant}/{script_id}/
            metadata.json   # name/description/category/versions/active
            v{N}.py         # immutable-ish content per version
            active.py       # copy of the activated version

    ``active.py`` is THE path scripted components bind (via ScriptManager,
    which hot-reloads on mtime change), so activating a version takes
    effect on the very next decode/route/filter call — the analog of the
    reference pushing activated content out to listening microservices
    (Instance.java .../versions/{versionId}/activate).
    """

    def __init__(self, root: str | pathlib.Path,
                 manager: ScriptManager | None = None):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.manager = manager or DEFAULT_MANAGER

    # ------------------------------------------------------------- paths
    def _script_dir(self, identifier: str, tenant: str,
                    script_id: str) -> pathlib.Path:
        for part in (identifier, tenant, script_id):
            if not part or "/" in part or part.startswith("."):
                raise ScriptError(f"invalid path component {part!r}")
        return self.root / identifier / tenant / script_id

    def _meta_path(self, d: pathlib.Path) -> pathlib.Path:
        return d / "metadata.json"

    def _read_meta(self, identifier: str, tenant: str,
                   script_id: str) -> tuple[pathlib.Path, dict]:
        d = self._script_dir(identifier, tenant, script_id)
        mp = self._meta_path(d)
        if not mp.exists():
            raise KeyError(f"script {script_id!r} not found")
        return d, _json.loads(mp.read_text())

    def _write_meta(self, d: pathlib.Path, meta: dict) -> None:
        tmp = self._meta_path(d).with_suffix(".tmp")
        tmp.write_text(_json.dumps(meta, indent=1))
        tmp.replace(self._meta_path(d))

    def active_path(self, identifier: str, tenant: str,
                    script_id: str) -> pathlib.Path:
        """The stable path scripted components reference in config specs."""
        return self._script_dir(identifier, tenant, script_id) / "active.py"

    # ------------------------------------------------------------- reads
    def list_scripts(self, identifier: str, tenant: str) -> list[dict]:
        base = self.root / identifier / tenant
        if not base.exists():
            return []
        out = []
        for d in sorted(base.iterdir()):
            mp = self._meta_path(d)
            if mp.exists():
                out.append(_json.loads(mp.read_text()))
        return out

    def list_by_category(self, identifier: str,
                         tenant: str) -> dict[str, list[dict]]:
        by_cat: dict[str, list[dict]] = {}
        for meta in self.list_scripts(identifier, tenant):
            by_cat.setdefault(meta.get("category") or "uncategorized",
                              []).append(meta)
        return by_cat

    def get_script(self, identifier: str, tenant: str,
                   script_id: str) -> dict:
        return self._read_meta(identifier, tenant, script_id)[1]

    def get_content(self, identifier: str, tenant: str, script_id: str,
                    version_id: str) -> str:
        d, meta = self._read_meta(identifier, tenant, script_id)
        if not any(v["versionId"] == version_id for v in meta["versions"]):
            raise KeyError(f"version {version_id!r} not found")
        return (d / f"{version_id}.py").read_text()

    # ------------------------------------------------------------ writes
    def create_script(self, identifier: str, tenant: str, *, script_id: str,
                      name: str | None = None, description: str = "",
                      category: str = "uncategorized",
                      content: str = "", activate: bool = True) -> dict:
        d = self._script_dir(identifier, tenant, script_id)
        if self._meta_path(d).exists():
            raise ValueError(f"script {script_id!r} already exists")
        d.mkdir(parents=True, exist_ok=True)
        meta = {
            "id": script_id, "name": name or script_id,
            "description": description, "category": category,
            "identifier": identifier, "tenant": tenant,
            "activeVersion": None, "versions": [],
        }
        self._write_meta(d, meta)
        meta = self._add_version(d, meta, content, "initial version")
        if activate:
            meta = self._activate(d, meta, meta["versions"][-1]["versionId"])
        return meta

    def _add_version(self, d: pathlib.Path, meta: dict, content: str,
                     comment: str) -> dict:
        vnum = 1 + max((int(v["versionId"][1:]) for v in meta["versions"]),
                       default=0)
        vid = f"v{vnum}"
        (d / f"{vid}.py").write_text(content)
        meta["versions"].append({
            "versionId": vid, "comment": comment,
            "createdMs": int(_time.time() * 1000),
        })
        self._write_meta(d, meta)
        return meta

    def update_script(self, identifier: str, tenant: str, script_id: str,
                      version_id: str, *, content: str | None = None,
                      name: str | None = None,
                      description: str | None = None,
                      category: str | None = None) -> dict:
        """Update version content and/or script metadata; re-syncs
        ``active.py`` when the updated version is the active one."""
        d, meta = self._read_meta(identifier, tenant, script_id)
        if not any(v["versionId"] == version_id for v in meta["versions"]):
            raise KeyError(f"version {version_id!r} not found")
        if content is not None:
            (d / f"{version_id}.py").write_text(content)
            if meta["activeVersion"] == version_id:
                meta = self._activate(d, meta, version_id)
        if name is not None:
            meta["name"] = name
        if description is not None:
            meta["description"] = description
        if category is not None:
            meta["category"] = category
        self._write_meta(d, meta)
        return meta

    def clone_version(self, identifier: str, tenant: str, script_id: str,
                      version_id: str, comment: str = "") -> dict:
        d, meta = self._read_meta(identifier, tenant, script_id)
        content = self.get_content(identifier, tenant, script_id, version_id)
        return self._add_version(d, meta, content,
                                 comment or f"cloned from {version_id}")

    def _activate(self, d: pathlib.Path, meta: dict,
                  version_id: str) -> dict:
        if not any(v["versionId"] == version_id for v in meta["versions"]):
            raise KeyError(f"version {version_id!r} not found")
        shutil.copyfile(d / f"{version_id}.py", d / "active.py")
        # bump mtime explicitly: copyfile + coarse filesystem timestamps
        # could otherwise leave the ScriptManager's (path, mtime) cache
        # thinking nothing changed
        import os as _os

        _os.utime(d / "active.py")
        meta["activeVersion"] = version_id
        self._write_meta(d, meta)
        return meta

    def activate(self, identifier: str, tenant: str, script_id: str,
                 version_id: str) -> dict:
        d, meta = self._read_meta(identifier, tenant, script_id)
        return self._activate(d, meta, version_id)

    def delete_script(self, identifier: str, tenant: str,
                      script_id: str) -> bool:
        d = self._script_dir(identifier, tenant, script_id)
        if not self._meta_path(d).exists():
            return False
        shutil.rmtree(d)
        return True
