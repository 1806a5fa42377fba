"""Tools of the port: measurements and checks on a CUDA card, each a script
run from the repo root as ``python3 fpga_mpeg2_encoder_tpu_torch/tools/<name>.py``
(``--device cpu`` where a tool has a CPU mode).  Importing a tool runs
nothing."""
