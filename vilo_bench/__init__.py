"""The benchmark of `cerberus_tpu_torch` on an NVIDIA H100: batched
Levenberg-Marquardt solves of many VILO sliding windows (the fleet path).

One command runs one cell once:

    python3 -m vilo_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that measures (traffic generation, the plain reference, the
comparison that decides `correct`, the trace reduction, the peaks) lives in
this folder and imports nothing of the JAX package; only the entries
(`entries/`) import the program under test. See README.md.
"""
