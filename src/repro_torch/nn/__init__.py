from .core import (dense_init, embed_init, rms_norm, rope, swiglu,
                   cross_entropy_chunked)

__all__ = ["dense_init", "embed_init", "rms_norm", "rope", "swiglu",
           "cross_entropy_chunked"]
