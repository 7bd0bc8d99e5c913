"""The port's evaluation entry points (counterparts of the JAX repo's
`evals/long_run.py`, `evals/loop_replay.py` and `evals/run_configs.py`),
each run as `python -m cerberus_tpu_torch.evals.<name>` and driven
in-process through its `main(argv=None)`, which returns its result dict."""
