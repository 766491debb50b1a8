"""The plain reference: a DeTikZify v1 model in PyTorch with float32
products and TF32 off, over the yardstick's seeded weights
(``h100bench.weights``), rounded to the configuration's weight type
again from those weights, its activations held in the configuration's
type. It imports neither JAX nor ``detikzify_tpu`` nor
``detikzify_torch``, and it takes nothing that the program made.
"""
