from repro_torch.optim.adam import OptState, adam_init, adam_update, adamw
from repro_torch.optim.compress import dequantize_int8, ef_int8_allreduce, quantize_int8
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = [
    "OptState",
    "adam_init",
    "adam_update",
    "adamw",
    "cosine_schedule",
    "linear_warmup_cosine",
    "ef_int8_allreduce",
    "quantize_int8",
    "dequantize_int8",
]
