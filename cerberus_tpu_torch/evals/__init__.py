"""The port's evaluation, measurement and diagnostic entry points
(counterparts of the JAX repo's `evals/long_run.py`,
`evals/loop_replay.py`, `evals/run_configs.py`, `evals/robustness.py`, of
its measurement drivers `evals/profile_inloop.py`,
`evals/profile_batched.py`, `evals/profile_solver.py`,
`evals/profile_streaming.py`, `evals/bench_klt.py` and
`evals/multichip_scaling.py`, and of its eleven diagnostics
`evals/diag_*.py`), each run as `python -m cerberus_tpu_torch.evals.<name>`
and driven in-process through its `main(argv=None)`, which returns its
result dict."""
