"""Time the port's attention kernels of several checkouts on one card, in
turns, and hash their forward outputs.

Each tree (a directory that holds a checkout's ``chip_smoke.py`` and
``sitewhere_tpu_torch/``, e.g. a ``git archive`` of the parent unpacked
under the git-ignored ``_checkout/``) runs in a subprocess of its own, in
the order given (parent, change, change, parent compares two commits on
one card), builds its own kernels and gives one record:

* the card (``nvidia-smi`` name and power limit) and ptxas's registers and
  spills of the attention kernels, with any ptxas warning;
* the SHA-256 of the forward's output and lse at each HASHED case, so two
  trees can be compared bit for bit;
* the forward and the backward at each shape of TIMED, causal, against
  SDPA and the floors (``chip_smoke._c6_timings``: medians of single calls
  between CUDA events, REPS of them).

It checks no output: ``chip_smoke.py``'s C6 phase holds the kernels to
their plain versions.

    python3 chip_ab.py --out ab.json _checkout/parent . . _checkout/parent

It needs the card: a tree whose worker finds none, or fails, gives a
record with its error, and the run exits 1.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve()

# name: (B, S, H, D, dtype name), all causal: the head-dim-64 shapes
# (the default d_model at 4 heads, the d_model=384, heads=8 model's D = 48
# padded to 64) and the rows held to run-to-run noise
TIMED = {
    "d64_bf16": (8, 16384, 4, 64, "bfloat16"),
    "d64_f16": (8, 16384, 4, 64, "float16"),
    "d48_bf16": (8, 16384, 8, 48, "bfloat16"),
    "d128_bf16": (8, 16384, 2, 128, "bfloat16"),
    "d128_f16": (8, 16384, 2, 128, "float16"),
    "d16_bf16": (8, 16384, 16, 16, "bfloat16"),
    "d32_bf16": (8, 16384, 8, 32, "bfloat16"),
    "d32_f16": (8, 16384, 8, 32, "float16"),
}
# the timed calls a shape, as chip_smoke.py's C6 phase takes
REPS = 10
# name: (B, S, H, D, dtype name, causal, sm_scale)
HASHED = {
    f"d{d}_{t}_{name}": (b, s, h, d, t, c, x)
    for d in (32, 128) for t in ("bfloat16", "float16")
    for name, (b, s, h, c, x) in {"s1000_causal": (2, 1000, 2, True, None),
                                  "s777_full": (2, 777, 2, False, None),
                                  "s1_causal": (2, 1, 2, True, None),
                                  "scale-0.3": (2, 333, 2, True, -0.3),
                                  "main": (8, 16384, 2, True, None)}.items()
}


def _sha(t) -> str:
    import torch

    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def worker(tree: pathlib.Path, shapes: list[str], sass: pathlib.Path | None = None) -> dict:
    """One tree's record (see the module docstring); runs in its own process."""
    os.chdir(tree)
    # the tree's own modules only, never this script's checkout's
    sys.path[:] = [str(tree)] + [p for p in sys.path[1:] if pathlib.Path(p).resolve() != HERE.parent]
    import torch

    import chip_smoke as cs
    from sitewhere_tpu_torch import cuda_build

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    fa, dev = cs.fa, torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_build.build([fa.KERNEL, fa.BWD_KERNEL])
    text = cuda_build.build_info[fa.KERNEL]["ptxas"]
    rec = {"tree": str(tree), "card": cs.card_line(), "build_s": time.perf_counter() - t0,
           "ptxas": cs.ptxas_resources(text, prefix="flash_attention"),
           "ptxas_notes": [ln.strip() for ln in text.splitlines()
                           if "arning" in ln or "C75" in ln or "serializ" in ln]}
    if sass is not None:
        lib = cuda_build._lib_path(fa.KERNEL)
        cuobjdump = pathlib.Path(cuda_build.find_nvcc()).with_name("cuobjdump")
        sass.write_text(subprocess.run([str(cuobjdump), "-sass", str(lib)],
                                       capture_output=True, text=True).stdout)
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"bfloat16": torch.bfloat16, "float16": torch.float16}
    rec["hashes"] = {}
    for name, (b, s, h, d, t, causal, scale) in HASHED.items():
        q, k, v = cs.fused_qkv(b, s, h, d, dtypes[t], dev, torch.Generator(
            device=dev).manual_seed(7))
        o, lse = fa.flash_attention_forward(q, k, v, causal=causal, sm_scale=scale)
        torch.cuda.synchronize()
        rec["hashes"][name] = {"o": _sha(o), "lse": _sha(lse)}
        del q, k, v, o, lse
    rec["timings"] = {}
    for name in shapes:
        b, s, h, d, t = TIMED[name]
        q, k, v = cs.fused_qkv(b, s, h, d, dtypes[t], dev, gen)
        do = torch.randn(q.shape, device=dev, generator=gen).to(q.dtype)
        rec["timings"][name] = cs._c6_timings(q, k, v, do, True, dev, REPS)
        del q, k, v, do
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path, required=True)
    ap.add_argument("--shapes", default=",".join(TIMED),
                    help="comma-separated names of TIMED to time (default: all)")
    ap.add_argument("--sass", action="store_true",
                    help="also write each tree's forward SASS (cuobjdump) beside --out")
    ap.add_argument("--worker", type=pathlib.Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shapes = [x for x in args.shapes.split(",") if x]
    if args.worker is not None:
        rec = worker(args.worker.resolve(), shapes,
                     args.out.with_suffix(".sass") if args.sass else None)
        args.out.write_text(json.dumps(rec))
        return 0
    args.out.parent.mkdir(parents=True, exist_ok=True)
    runs, failed = [], False
    for i, tree in enumerate(args.trees):
        part = args.out.with_name(f"{args.out.stem}.{i}.json")
        cmd = [sys.executable, str(HERE), "--worker", str(tree.resolve()),
               "--out", str(part.resolve()), "--shapes", ",".join(shapes)] + (
                   ["--sass"] if args.sass else [])
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            err = res.stderr[-4000:] if res.returncode else None
        except subprocess.TimeoutExpired as e:
            err = f"timed out: {e}"
        rec = json.loads(part.read_text()) if err is None else {"tree": str(tree),
                                                                "error": err}
        failed |= err is not None
        runs.append(rec)
        print(json.dumps({"tree": str(tree), "error": err, "timings_ms": {
            n: {"forward": x["forward"]["ms"], "sdpa_forward": x["forward"]["library_ms"],
                "backward": x["backward"]["ms"], "sdpa_backward": x["backward"]["library_ms"]}
            for n, x in rec.get("timings", {}).items()}}), flush=True)
    args.out.write_text(json.dumps({"runs": runs}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
