"""Per-arch step pieces for the trainers (counterpart of the GNN tables of
`repro/launch/steps.py`).

Only the GNN loss and init tables are ported; `build_cell` and the sharded
cell builders of the reference wait for the port's mesh (ROADMAP Queue 1
item 7).
"""
from __future__ import annotations

from repro_torch.models import gnn as gnn_mod

_GNN_LOSS = {
    "egnn": gnn_mod.egnn_loss,
    "meshgraphnet": gnn_mod.mgn_loss,
    "schnet": gnn_mod.schnet_loss,
    "graphsage-reddit": gnn_mod.sage_loss,
}

_GNN_INIT = {
    "egnn": gnn_mod.egnn_init,
    "meshgraphnet": gnn_mod.mgn_init,
    "schnet": gnn_mod.schnet_init,
    "graphsage-reddit": gnn_mod.sage_init,
}
