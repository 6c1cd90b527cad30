"""The benchmark of barbell_tpu_torch (see README.md): run with
``python3 benchmark/run.py``; its side processes run as
``python -m benchmark.feeder`` and ``python -m benchmark.digester``."""
