from .config import ModelConfig
from .model import (decode_step, decode_step_slab, encode_cross_kv, forward,
                    init_decode_cache, init_params, init_state_cache, init_verify_ckpts,
                    param_count, prefill, prefill_chunk, verify_chunk,
                    verify_chunk_slab)

__all__ = ["ModelConfig", "init_params", "prefill_chunk", "decode_step",
           "param_count", "verify_chunk", "init_decode_cache", "prefill",
           "decode_step_slab", "verify_chunk_slab", "init_state_cache",
           "init_verify_ckpts", "encode_cross_kv", "forward"]
