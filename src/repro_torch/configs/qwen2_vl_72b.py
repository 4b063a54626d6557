"""qwen2-vl-72b — VLM backbone: M-RoPE, dynamic resolution
[arXiv:2409.12191; hf].

The vision frontend is a STUB: ``models/api.py::input_shapes`` gives
precomputed patch embeddings plus 3-stream (t, h, w) M-RoPE position ids.
head_dim 128 → sections (16, 24, 24) rotary split per the paper.
"""
from repro_torch.core.arch import ArchConfig

FULL = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064, rope_theta=1e6,
    rope_variant="mrope", mrope_sections=(16, 24, 24),
    frontend="vision",
)

SMOKE = ArchConfig(
    name="qwen2-vl-72b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=320, vocab_pad_multiple=64, head_dim=16,
    rope_variant="mrope", mrope_sections=(2, 3, 3),
    frontend="vision",
)
