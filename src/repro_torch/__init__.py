"""PyTorch + CUDA port of VQ-GNN (the H100 twin of ``repro``).

The package mirrors ``repro``'s module layout so each port module sits
where its JAX counterpart does.  It imports ``torch`` and numpy only --
never ``jax`` and never a module of ``repro`` (the host-side numpy modules
are carried as copies).  The TPU kernels of the serving and training
paths (``vq_assign``, ``vq_update`` with its narrow emit, ``spmm_ell``
with its quantized form and its backward ``spmm_ell_t``, ``context_ell``
with its ``w_t`` epilogue and its quantized forms) are
hand-written CUDA C++ for ``sm_90a`` under ``kernels/csrc/``, built with
``nvcc`` on first use.

Slice coverage: serving, and training for node classification and link
prediction (Hits@50), on one device (Alg. 1, the Alg. 2 codebook update,
the Eq. 7 injection, RMSprop / Adam) in every precision tier (fp32; int8 /
fp8 codeword snapshots with uint8 or nibble-packed assignment tables),
all five backbones (GCN, SAGE, GIN, GAT, the Graph Transformer), on every
dataset look-alike of the reference; and the multi-device GNN on
``torch.distributed`` (``distributed/``: ranks as processes, the
data-parallel epoch, row-sharded graph state, sharded inference and
serving).  The LM's meshes raise a clear error that names the later
slice (see ROADMAP.md).
"""
