from repro_torch.sharding.policy import (AxisRules, constrain,
                                         logical_to_pspec, make_rules,
                                         params_pspecs, use_rules)

__all__ = ["AxisRules", "constrain", "logical_to_pspec", "make_rules",
           "params_pspecs", "use_rules"]
