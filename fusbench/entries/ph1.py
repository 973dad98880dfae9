"""The program side of the ``ph1`` entry: ``drivers/ph1.py::build_model`` on
the box lattice; every other function is ``fusbench.program``'s."""

from fusbench.program import DTYPES


def build_model(config: dict, traffic: dict, device):
    """(model, steps a period) of the cell."""
    from fenicsxfus_tpu_torch.drivers import ph1

    model, _, _, _, spp = ph1.build_model(config["sc"], traffic["bm"], config["nx"],
                                          dtype=DTYPES[config["dtype"]], cfl=traffic["cfl"],
                                          device=device)
    return model, spp
