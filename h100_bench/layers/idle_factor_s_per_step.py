"""idle_factor_s_per_step: spans.idle_factor_s_per_step in example01_2d.lm_step; it moves lm_steps_per_s."""

from h100_bench.spans import idle_factor_s_per_step as read  # noqa: F401
