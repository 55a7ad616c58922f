"""Developer tools of the port that run on the card: `bench_gather`, the gather
microbenchmarks (the port of `tools/dev/bench_gather.py`), `profile_backward`,
K4 and K5 at the training path's shapes, and `profile_coord`, K7 and K6 at
the plane sweep's and the main path's shapes."""
