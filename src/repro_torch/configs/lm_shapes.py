"""Shared LM-family shape set (copy of `repro/configs/lm_shapes.py`)."""

SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    # decode (1 token vs a 524288-entry KV cache) is O(L) per token, so it
    # runs for full-attention archs too — see DESIGN.md §4 long_500k note.
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

# the JAX package's smoke shapes (divisible by its production meshes)
SMOKE_SHAPES = {
    "train_4k": {"kind": "train", "seq": 256, "batch": 64},
    "prefill_32k": {"kind": "prefill", "seq": 256, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 512, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 1024, "batch": 1},
}
