"""The program side of the ``hitu`` entry: ``drivers/hitu.py::build_model``
(``"mesh": "box"``) or ``build_bowl_model`` (``"bowl"``); every other
function is ``fusbench.program``'s."""

from fusbench.program import DTYPES


def build_model(config: dict, traffic: dict, device):
    """(model, steps a period) of the cell."""
    from fenicsxfus_tpu_torch.drivers import hitu

    build = hitu.build_bowl_model if traffic["mesh"] == "bowl" else hitu.build_model
    model, _, _, spp = build(*config["variant"], config["nx"], degree=config["degree"],
                             f0=config["f0"], cfl=traffic["cfl"], dtype=DTYPES[config["dtype"]],
                             device=device)
    return model, spp
