"""loop.plan_ms_per_period: host milliseconds a ``rk_record`` call (one
period) in the port's spans ``fus.loop.step_build`` and
``fus.loop.sensor_plan``, the per-call step build and sensor plan, over
every call of the run (``ctx["spans"]``, the port's registry after the
traced periods)."""


def read(ctx):
    s = ctx.get("spans") or {}
    if "fus.rk_record" not in s:
        return None
    ms = 1e3 * sum(s[n]["total_s"] for n in ("fus.loop.step_build", "fus.loop.sensor_plan")
                   if n in s)
    return ms / s["fus.rk_record"]["calls"]
