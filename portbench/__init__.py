"""The benchmark of the PyTorch and CUDA port (`sat_bundleadjust_tpu_torch`).

One run: `python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` from the root of a checkout, on a machine with a CUDA card.
The cells, configurations and metrics are named in BENCHMARK.json; each
configuration, traffic mix, per-layer metric reader and set of limits is a
file of its own under this folder, found by its name (`spec.py`).
"""
