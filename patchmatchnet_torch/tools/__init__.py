"""Host tools of the port, each runnable as a subcommand of the command line:
COLMAP import and export (`colmap_import`, `colmap_export`, over the model
codecs of `colmap_model`), the DTU and ETH3D dataset converters
(`convert_dtu`, `convert_eth3d`) and the point-cloud viewer (`visualize`).
Ports of `patchmatchnet_tpu/tools/`, reading and writing through
`data.codecs`; their output files equal the JAX tools' byte for byte."""
