"""Optimizers, schedules and gradient codecs over the port's parameter
trees (port of `repro/optim`)."""
from .adamw import (Optimizer, adamw, sgd, apply_updates, global_norm,
                    clip_by_global_norm)
from .schedules import warmup_cosine, constant
from .compression import (topk_compress_decompress, int8_compress_decompress,
                          ErrorFeedbackState, compressed_gradients)
