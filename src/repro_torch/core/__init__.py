"""The paper's primary contribution, VQ-GNN (torch twin of ``repro.core``).

codebook.py        -- streaming EMA codebooks, product VQ, whitening (Alg. 2)
message_passing.py -- approximated fwd/bwd message passing (Eq. 6/7),
                      the Eq. 7 backward injection
conv.py            -- generalized graph convolution operands (Table 1/5)
bounds.py          -- Theorem 2 / Corollary 3 as executable checks
"""
from repro_torch.core.codebook import (CodebookConfig, CodebookState,
                                       init_codebook, kmeanspp_init)
from repro_torch.core.conv import (ConvOperands, LayerVQState, MinibatchPack,
                                   branch_histogram, fixed_conv_operands,
                                   init_layer_vq_state,
                                   out_of_batch_cluster_mass,
                                   refresh_assignment)
from repro_torch.core.message_passing import (approx_message_passing,
                                              inject_context_grad,
                                              inject_context_grad_materialized,
                                              inject_context_grad_table,
                                              reconstruct)

__all__ = ["CodebookConfig", "CodebookState", "init_codebook",
           "kmeanspp_init", "ConvOperands", "LayerVQState", "MinibatchPack",
           "branch_histogram", "fixed_conv_operands", "init_layer_vq_state",
           "out_of_batch_cluster_mass", "refresh_assignment",
           "approx_message_passing", "inject_context_grad",
           "inject_context_grad_materialized", "inject_context_grad_table",
           "reconstruct"]
