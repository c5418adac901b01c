"""Sequence parallelism over ``torch.distributed`` (port of
``sitewhere_tpu/parallel/ring_attention.py``); the multi-GPU engines of
``sitewhere_tpu/parallel/`` are not ported yet."""
