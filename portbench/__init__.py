"""The serving benchmark of ``repro_torch`` on the H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output.  Everything a cell needs is
found by name: its configuration under ``configs/``, its traffic mix under
``traffic/``, the limit of its output check under ``checks/`` and one
reader a metric under ``metrics/``.  The plain reference that decides
``correct`` lives under ``reference/`` and imports nothing of the port.
"""
