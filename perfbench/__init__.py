"""The benchmark of ``recommendit_tpu_torch`` on NVIDIA GPUs.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output. Everything a cell is made of
is found by the names in ``BENCHMARK.json``: a configuration file under
``configs/`` (its ``system`` names the module in ``systems/``, which holds
the program to the plain model of ``reference/``), a traffic mix under
``traffic/`` read by ``traffic.py``, and one reader a metric under
``metrics/``. ``control.py`` runs the checks' controls.

Nothing here imports JAX or the JAX package; of the harness only ``systems/``
imports the port, and ``reference/`` imports neither.
"""
