"""seamless-m4t-large-v2 — audio enc-dec, multimodal  [arXiv:2308.11596; hf].

24L is interpreted as 24 encoder + 24 decoder layers (the HF config's
speech-encoder/text-decoder depths).  The audio frontend is a stub: the
encoder takes precomputed frame embeddings; enc_seq = seq/4 models the
conv subsampling stage.
"""
from repro_torch.core.arch import ArchConfig

FULL = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, n_enc_layers=24, is_encdec=True,
    d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206, rope_theta=1e4,
    frontend="audio", enc_seq_divisor=4,
)

SMOKE = ArchConfig(
    name="seamless-m4t-large-v2-smoke", family="audio",
    n_layers=2, n_enc_layers=2, is_encdec=True,
    d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=320, vocab_pad_multiple=64,
    frontend="audio", enc_seq_divisor=4,
)
