from .adamw import (OptConfig, apply_updates, global_norm, init_opt_state,
                    schedule_lr)
from .compression import (compressed_psum, dequantize_int8, ef_compress,
                          quantize_int8)

__all__ = ["OptConfig", "apply_updates", "global_norm", "init_opt_state",
           "schedule_lr", "compressed_psum", "dequantize_int8", "ef_compress",
           "quantize_int8"]
