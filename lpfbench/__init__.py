"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

    python3 -m lpfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout: one run of one cell of ``BENCHMARK.json``
on the card, its last line of output one JSON object with the result
(``README.md`` beside this file)."""
