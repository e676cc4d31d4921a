"""The H100 benchmark of ``impersonator_tpu_torch``: one command runs one
cell of ``BENCHMARK.json`` once (``python3 lwg_bench/run.py --workload
NAME --seed N --seconds S --trace 0|1``). Configurations, traffic mixes
and metrics are files found by the names ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py``; ``reference/`` holds the plain float32 model
that decides ``correct`` and that the roofline and mfu counts come
from."""
