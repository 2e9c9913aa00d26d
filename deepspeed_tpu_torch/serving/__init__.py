"""Continuous-batching serving over a paged KV cache (counterpart of
``deepspeed_tpu/serving``; serving/server.py holds the subsystem map).
Not ported yet: the multi-replica router (``serving/router.py``)."""

from deepspeed_tpu_torch.serving.kv_cache import (  # noqa: F401
    BlockAllocator, BlockAllocatorError, PagedKVCache, PrefixCache)
from deepspeed_tpu_torch.serving.paged_attention import (  # noqa: F401
    paged_decode_attention, paged_prefill_attention, paged_verify_attention)
from deepspeed_tpu_torch.serving.prefill import ChunkedPrefill  # noqa: F401
from deepspeed_tpu_torch.serving.runner import PagedGPT2Runner  # noqa: F401
from deepspeed_tpu_torch.serving.sampling import (  # noqa: F401
    sample_tokens, top_p_filter)
from deepspeed_tpu_torch.serving.scheduler import (  # noqa: F401
    ContinuousBatchingScheduler, Request, RequestState, StepPlan)
from deepspeed_tpu_torch.serving.server import (  # noqa: F401
    RequestOutput, ServingAdmissionPausedError, ServingEngine,
    ServingLivelockError)
