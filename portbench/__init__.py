"""The benchmark of ``dip_admm_tpu_torch`` on an NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell is made of is found by name: its
configuration in ``configs/``, its traffic mix in ``mixes/``, its
correctness limits in ``limits/``, each per-layer metric's reader in
``metrics/`` and each kernel's byte and operation count in ``counts/``.
The plain reference that decides ``correct`` is ``reference/``; it
imports nothing of the program. Nothing here imports JAX or the JAX
package.
"""
