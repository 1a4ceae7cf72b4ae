# Hand-written Hopper kernels of the port, one package per TPU kernel of the
# reference: ref.py (plain PyTorch), kernel.py (the CUDA binding), ops.py
# (dispatch by device). Sources are in ../csrc, built by build.py.
