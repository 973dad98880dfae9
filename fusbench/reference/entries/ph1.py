"""The reference side of the ``ph1`` entry: every part is the default of
``cell.reference_side`` (the explicit RK4 Westervelt reference
``reference.model.ReferenceModel``, ``bounds.step_floor`` and
``start.start_state``)."""
