"""The benchmark of ``tpu_deflate_torch`` on an NVIDIA GPU.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
per-layer metric or kernel is a file of its own under this folder, found
by its name (see ``README.md``).  Nothing here imports ``jax`` or the JAX
package; the program under test is reached through its public API.
"""
