"""The benchmark's frozen plain reference: 3D gaussian and 2D surfel
rendering, their gradients by autograd, and Adam, in plain PyTorch.

It imports neither JAX nor the JAX package nor anything of the PyTorch
port it judges, and takes nothing the port has made: it projects, bins,
sorts and blends on its own from the raw parameters and the camera.
"""
