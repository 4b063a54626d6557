"""phi3.5-moe-42b-a6.6b — MoE 16 experts top-2  [hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
from repro_torch.core.arch import ArchConfig

FULL = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab_size=32064, rope_theta=1e4,
    n_experts=16, experts_per_tok=2,
)

SMOKE = ArchConfig(
    name="phi3.5-moe-42b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=320, vocab_pad_multiple=64,
    n_experts=4, experts_per_tok=2,
)
