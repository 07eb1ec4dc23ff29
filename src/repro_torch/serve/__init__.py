"""Serving tier: paged KV cache + continuous-batching decode engine.

Port of the JAX package's ``repro/serve``. Entry points:
:class:`~repro_torch.serve.engine.DecodeServer` (continuous batching),
:func:`~repro_torch.serve.engine.run_sequential` (baseline),
:func:`~repro_torch.serve.engine.serving_params_from_checkpoint` (FL
checkpoint -> serving weights for hot-swap).
"""
from repro_torch.serve.engine import (DecodeServer, ServeConfig, Session,
                                      run_sequential,
                                      serving_params_from_checkpoint)
from repro_torch.serve.paged_cache import (SCRATCH_BLOCK, BlockAllocator,
                                           gather_session_cache,
                                           session_table,
                                           write_prefill_to_pages)

__all__ = [
    "DecodeServer", "ServeConfig", "Session", "run_sequential",
    "serving_params_from_checkpoint", "BlockAllocator", "SCRATCH_BLOCK",
    "session_table", "write_prefill_to_pages", "gather_session_cache",
]
