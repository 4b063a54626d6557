"""granite-3-8b — dense, GQA  [hf:ibm-granite/granite-3.0-2b-base; hf]."""
from repro_torch.core.arch import ArchConfig

FULL = ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab_size=49155, rope_theta=1e4,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="granite-3-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab_size=320, vocab_pad_multiple=64,
    tie_embeddings=True,
)
