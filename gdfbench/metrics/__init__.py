"""Per-layer metric readers, one module a metric, found by the metric's name
('.' and '-' read as '_').

Each module has `read(ctx)`, which returns the metric's value or None when
the run gave it nothing to read (the harness then leaves the metric out).
`ctx` is a dict: `trace` (trace.Trace of the traced window, or None),
`queries` (queries in the traced window), `filter_bytes` (their filters'
logical bytes, roofline.filter_bytes, this process's shards), `window_s`
(the window's seconds on the host clock), `exchange_s` (the mesh's
`mesh.exchange.seconds` over the window, None without a mesh) and
`local_shards`.
"""
