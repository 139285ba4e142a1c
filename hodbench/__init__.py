"""The benchmark of the PyTorch/CUDA port: HoD SSD and SSSP queries served
through ``repro_torch``'s ``QueryServer`` on one H100.

``python3 hodbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything a cell is made of is data found by name:
``configs/<config>.json`` (the graph and the index settings),
``traffic/<traffic>.json`` (the mix, read by :mod:`hodbench.loadgen`),
``graphs/<kind>.py`` (a frozen generator) and ``metrics/<metric>.py``
(one reader a metric).  The yardstick (:mod:`hodbench.yardstick`), the
plain reference (:mod:`hodbench.reference`) and the comparison that
decides ``correct`` (:mod:`hodbench.verdict`) live here too, apart from
the program they measure.
"""
