"""Developer tools of the port: `bench_gather`, the gather microbenchmarks
(the port of `tools/dev/bench_gather.py`); `bench_dataset_configs`, the
estimator at the ETH3D and Tanks geometries, `bf16_accuracy` and
`bf16_scene_check`, bf16 against f32 (the ports of the `tools/dev/` tools
of those names); `profile_backward`, K4 and K5 at the training path's
shapes; `profile_coord`, K7 and K6 at the plane sweep's and the main
path's shapes; `profile_parallel`, data parallel against one rank."""
