from .config import ModelConfig
from .model import (decode_step, init_params, param_count, prefill_chunk,
                    verify_chunk)

__all__ = ["ModelConfig", "init_params", "prefill_chunk", "decode_step",
           "param_count", "verify_chunk"]
