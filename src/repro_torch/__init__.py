"""PyTorch + CUDA port of VQ-GNN's serving path (the H100 twin of ``repro``).

The package mirrors ``repro``'s module layout so each port module sits
where its JAX counterpart does.  It imports ``torch`` and numpy only --
never ``jax`` and never a module of ``repro`` (the host-side numpy modules
are carried as copies).  The three TPU kernels of the serving path
(``vq_assign``, ``spmm_ell``, ``context_ell``) are hand-written CUDA C++
for ``sm_90a`` under ``kernels/csrc/``, built with ``nvcc`` on first use.

Slice coverage: forward/inference only, fp32 operands, int32 assignment
tables, GCN/SAGE/GIN backbones.  Training, the quantized precision tiers,
GAT/Transformer, meshes and sharded graph state raise a clear error that
names the later slice (see ROADMAP.md).
"""
