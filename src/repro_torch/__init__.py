"""PyTorch/CUDA port of the LM runtime, for one NVIDIA H100.

It mirrors the JAX package's layout (`configs`, `kernels/<name>/{ops,ref}`,
`models`, `runtime`, `launch`) and imports only torch, numpy and the
stdlib: never JAX, never the JAX package.  Entry points run on the card
(`device="cuda"`) unless the caller asks for the CPU, where every kernel
wrapper takes its plain PyTorch version.
"""
