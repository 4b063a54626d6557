"""falcon-mamba-7b — attention-free Mamba1  [arXiv:2410.05355; unverified]."""
from repro_torch.core.arch import ArchConfig

FULL = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_variant="mamba1", ssm_expand=2,
)

SMOKE = ArchConfig(
    name="falcon-mamba-7b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=320, vocab_pad_multiple=64,
    ssm_state=8, ssm_variant="mamba1", ssm_expand=2,
)
