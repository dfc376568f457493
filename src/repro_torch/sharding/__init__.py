from repro_torch.sharding.rules import (DEFAULT_RULES, EXECUTED_RULE_SETS,
                                        FSDP_RULES, RULE_SETS, SEQPAR_RULES,
                                        LogicalRules, PartitionSpec,
                                        executed_rules, local_slice,
                                        resolve_spec, shard_shape, spec_axes,
                                        tree_shardings, with_constraint)

__all__ = ["LogicalRules", "DEFAULT_RULES", "FSDP_RULES", "SEQPAR_RULES",
           "RULE_SETS", "EXECUTED_RULE_SETS", "PartitionSpec",
           "executed_rules", "resolve_spec", "tree_shardings", "shard_shape",
           "local_slice", "spec_axes", "with_constraint"]
