"""The port's benchmark on one NVIDIA H100: ``python3 bench_h100/run.py``.

See ``README.md`` in this folder for how a cell's files are found by name.
"""
