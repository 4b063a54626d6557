"""dbrx-132b — MoE 16 experts top-4, fine-grained  [hf:databricks/dbrx-base; unverified]."""
from repro_torch.core.arch import ArchConfig

FULL = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352, rope_theta=5e5,
    n_experts=16, experts_per_tok=4,
)

SMOKE = ArchConfig(
    name="dbrx-132b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=320, vocab_pad_multiple=64,
    n_experts=4, experts_per_tok=2,
)
