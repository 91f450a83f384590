"""PyTorch + CUDA port of VQ-GNN (the H100 twin of ``repro``).

The package mirrors ``repro``'s module layout so each port module sits
where its JAX counterpart does.  It imports ``torch`` and numpy only --
never ``jax`` and never a module of ``repro`` (the host-side numpy modules
are carried as copies).  The TPU kernels of the serving and training
paths (``vq_assign``, ``vq_update``, ``spmm_ell`` and its backward
``spmm_ell_t``, ``context_ell`` with its ``w_t`` epilogue) are
hand-written CUDA C++ for ``sm_90a`` under ``kernels/csrc/``, built with
``nvcc`` on first use.

Slice coverage: serving and node-task training on one device (Alg. 1,
the Alg. 2 codebook update, the Eq. 7 injection, RMSprop / Adam), fp32
operands, int32 assignment tables, GCN/SAGE/GIN backbones.  The quantized
precision tiers, GAT/Transformer, the link task and meshes raise a clear
error that names the later slice (see ROADMAP.md).
"""
