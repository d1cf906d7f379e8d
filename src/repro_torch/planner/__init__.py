"""Planner (paper §4.3). This slice of the port carries only
``planner.model.PlanConfig`` and ``coerce_config``; import the submodule
directly."""
