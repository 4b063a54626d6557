"""gemma3-4b — dense, 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt; unverified]."""
from repro_torch.core.arch import ArchConfig

FULL = ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_ff=10240, vocab_size=262144, head_dim=256,
    sliding_window=1024, local_global_ratio=5,
    rope_theta=1e6, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="gemma3-4b-smoke", family="dense",
    n_layers=7, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=320, vocab_pad_multiple=64, head_dim=16,
    sliding_window=8, local_global_ratio=5, tie_embeddings=True,
)
