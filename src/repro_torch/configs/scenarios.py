"""Scenario-matrix registry: the GNN axes of the paper's comparison (twin
of ``repro.configs.scenarios``).

The matrix is backbone x scale method x task:

  backbones      the paper's Table 2 convolution types (``nn.gnn_layers``)
  scale methods  the full-graph oracle, VQ-GNN (Alg. 1), the four sampling
                 baselines and the VQ/sampling hybrid
                 (``train.gnn_trainer.train_scenario``)
  tasks          node classification / link prediction (the hybrid is
                 node-task only, as in the reference)

Kept apart from ``configs.registry``, the LM/speech/vision architectures,
which must never leak into the matrix.
"""
from repro_torch.train.gnn_trainer import SCALE_METHODS

MATRIX_BACKBONES = ("gcn", "sage", "gat", "gin", "transformer")

MATRIX_TASKS = ("node", "link")

# environment knobs read by train_scenario
SCENARIO_KNOBS = {
    "REPRO_SCALE_METHOD": "scale method when not passed explicitly "
                          f"(one of {SCALE_METHODS}; default 'vq')",
    "REPRO_SAMPLER_FANOUT": "per-layer fanout for ns_sage/labor/hybrid "
                            "(default 5)",
    "REPRO_WALK_LENGTH": "GraphSAINT random-walk length (default 3)",
    "REPRO_N_PARTS": "Cluster-GCN partition count (default 32)",
    "REPRO_HYBRID_CTX": "hybrid context-slot budget per batch "
                        "(default batch_size)",
    "REPRO_SAMPLER_EXECUTOR": "0 -> per-batch host loop instead of the "
                              "sampler epoch executor (default on)",
}


def matrix_cells(tasks=("node",)):
    """Enumerate (backbone, scale_method, task) cells of the matrix."""
    return [(b, m, t) for t in tasks for b in MATRIX_BACKBONES
            for m in SCALE_METHODS]


def assert_gnn_only(names) -> None:
    """Raise if an LM/speech/vision arch id of ``configs.registry`` shows
    up where a GNN backbone is expected, or a name is no backbone."""
    from repro_torch.configs.registry import ARCHS
    leaked = sorted(set(names) & set(ARCHS))
    if leaked:
        raise ValueError(
            f"non-GNN arch ids {leaked} leaked into the scenario matrix; "
            f"matrix cells enumerate MATRIX_BACKBONES only")
    unknown = sorted(set(names) - set(MATRIX_BACKBONES))
    if unknown:
        raise ValueError(
            f"unknown backbones {unknown}; expected a subset of "
            f"{MATRIX_BACKBONES}")
