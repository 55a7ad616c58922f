"""Developer tools of the port that run on the card: `bench_gather`, the gather
microbenchmarks (the port of `tools/dev/bench_gather.py`), and
`profile_backward`, K4 and K5 at the training path's shapes."""
