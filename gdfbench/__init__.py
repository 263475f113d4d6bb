"""The benchmark of libgdf_tpu_torch: TPC-H queries back to back on the card.

One call of `python3 -m gdfbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>` generates the cell's tables on the card from the seed,
warms up the cell's own query, runs it in a closed loop of one client for
the window, checks a sample of the window's answers against a plain
reference, and prints one JSON line. Everything that belongs to one
configuration, traffic mix, query or per-layer metric sits in a file of
its own, found by the name that BENCHMARK.json gives it:

  configs/<config>.json     one deployment: scale factor, chips, columns
  traffic/<mix>.json        one traffic mix: query, loop, parameter rules,
                            read by mix.py
  queries/<query>.py        the query's plan over libgdf_tpu_torch
  reference/<query>.py      the plain torch reference and its comparison
  metrics/<metric>.py       one per-layer metric's reader
  data/tpch.py              the TPC-H generator (plain torch, on the card)

Nothing here imports jax or the JAX package; reference/ imports nothing of
libgdf_tpu_torch.
"""
