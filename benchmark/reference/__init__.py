"""The plain reference of the benchmark's configurations.

A frozen copy of the LTX-2 modules' plain mathematics in float32 PyTorch:
the Gemma-3 tower's hidden states, the text connectors, the video DiT and
the dual audio-video DiT, the distilled Euler loop, the tiled VAE decode,
the audio VAE and the HiFi-GAN vocoder. It imports nothing of the program:
no kernel, no cache, no batching. Its modules hold the weights the benchmark
drew (any dtype) and compute in the dtype of their inputs, float32, with
TF32 off; `set_precision(module, "fp8")` turns every matrix product and
convolution into an fp8 (e4m3) one, the control that has to fail the check.
"""
