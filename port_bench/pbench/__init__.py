"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

Everything that measures lives here, where a change to the program cannot
move it: the cells' lookup by name (``spec``), the data and traffic drawn
from the seed (``data``, ``traffic``), the plain reference and the
comparison that decides ``correct`` (``reference``, ``compare``), the
frozen work counts, peaks and kernel-name categories (``work``, ``peaks``,
``categories``), the profiler's reduction (``trace``) and the run itself
(``harness``).  Per-layer and end-to-end metrics are readers of their own
under ``port_bench/metrics/``.
"""
