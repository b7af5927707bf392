"""One file a hand-written kernel: the CUDA kernel names that implement
it (``PATTERNS``, regular expressions searched in the trace's names), the
route it serves (``MODE``: ``predict`` or ``train``), and ``launches``,
the work of each of its launches in one call of that route, counted from
the shapes of the layers it implements in the reference model at the
cell's sizes: each input byte read once, each output byte written once,
and the operations the algorithm needs, as ``(bytes, f32_ops,
product_ops, product_rate)``.

The counts are frozen copies of the ``bound_ms`` formulas that
``chip_smoke.py`` holds beside each kernel; they say what the layer's
work is, whatever implements it."""
