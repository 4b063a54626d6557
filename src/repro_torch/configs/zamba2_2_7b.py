"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention block every 6
layers  [arXiv:2411.15242; hf].

The shared transformer block (attention + MLP, weights SHARED across all
applications) runs after every ``attn_every`` Mamba2 layers; 54 layers →
9 groups of 6.  kv=32 refers to the shared block's MHA.
"""
from repro_torch.core.arch import ArchConfig

FULL = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000, rope_theta=1e4,
    ssm_state=64, ssm_variant="mamba2", ssm_expand=2,
    attn_every=6, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=320, vocab_pad_multiple=64,
    ssm_state=8, ssm_variant="mamba2", ssm_expand=2, ssm_heads=4,
    attn_every=3, tie_embeddings=True,
)
