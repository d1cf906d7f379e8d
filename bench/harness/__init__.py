"""The benchmark's fixed core: traffic, weights, timing, the FLOP and byte
arithmetic, the output check and the run of one cell. Configurations,
traffic mixes, per-layer metrics and references live in files of their
own beside it (``bench/configs``, ``bench/traffic``, ``bench/metrics``,
``bench/reference``, ``bench/checks``) and are found by name."""
