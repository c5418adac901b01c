"""sitewhere_tpu_torch: the PyTorch / CUDA port of the sitewhere_tpu engine.

The package mirrors ``sitewhere_tpu``'s module paths and public names, runs
on an NVIDIA GPU (Hopper, ``sm_90a``) and keeps every id and timestamp
lane int32 and every float lane float32, exactly as the JAX package does.
It imports ``torch``, numpy and the standard library only — never JAX,
flax, optax or anything of ``sitewhere_tpu``.

Entry points take an explicit ``device``; the default is ``"cuda"`` and a
missing GPU raises (see :func:`sitewhere_tpu_torch.compat.resolve_device`).
Pass ``device="cpu"`` to run on the CPU.
"""

__version__ = "0.1.0"
