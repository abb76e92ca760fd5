"""lm_steps_per_s: Levenberg-Marquardt steps (forward, then Jacobian) completed in the window over the window's seconds (host clock)."""

from h100_bench.readers import work_per_s as read  # noqa: F401
