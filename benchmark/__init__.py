"""The benchmark of the PyTorch + CUDA port (`basisu_rs_tpu_torch`).

`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on the card and
prints one JSON result line.  Everything a cell needs is found by name:
its configuration in `configs/`, its traffic mix in `traffic/`, the
driver the mix names in `drivers/`, and each metric's reader in
`metrics/`.  `reference/` holds the plain reference that decides
`correct`; it imports nothing of the program."""
