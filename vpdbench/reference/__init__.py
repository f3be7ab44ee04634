"""The plain reference: the VPD student in plain PyTorch, float32 with
TF32 off, written from the published descriptions. It imports nothing of
the port and takes nothing the port has made; the benchmark hands both
sides the same weights and inputs, made from the run's seed."""
