"""Plain PyTorch reference of VQ-GNN (Ding et al., NeurIPS 2021): the
mini-batch plan from the raw edges, the GCN and GAT layers with their
codeword context (Eq. 6) and the Eq. 7 gradient injection, the product-VQ
assignment and EMA update (Alg. 2), the masked cross-entropy, RMSprop,
and the inductive whole-graph inference.  It imports nothing of the
program under test and takes nothing the program made: it works from the
raw graph, the weights and the VQ state the benchmark drew from the seed.
Every product is float32 with TF32 off, unless a :class:`Precision` that
rounds to TF32 is passed (the benchmark's control)."""
