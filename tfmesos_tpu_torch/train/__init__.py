"""Single-device training: the seeded token stream, the optimizer and
the train/eval steps (port of ``tfmesos_tpu/train``)."""
