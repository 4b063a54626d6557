"""llama3.2-3b — dense, GQA, small llama3  [hf:meta-llama/Llama-3.2-1B; unverified]."""
from repro_torch.core.arch import ArchConfig

FULL = ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=128256, rope_theta=5e5,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="llama3.2-3b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=192, vocab_size=320, vocab_pad_multiple=64,
    tie_embeddings=True,
)
