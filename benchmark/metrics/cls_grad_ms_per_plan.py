"""cls_grad_ms_per_plan: device milliseconds of the classifier's input
gradient per plan, from the traced run's record of the host and the
device: the kernels launched under the harness's span around
`gradients` (the forward under grad) and under the autograd engine's events
(the backward). Nothing to read where no plan takes a gradient."""

CLS_SPAN = "bench.classifier_gradients"


def read(ctx):
    seconds = ctx.host_trace.device_time_under(
        lambda e: e.name == CLS_SPAN or e.name.startswith("autograd::engine::evaluate_function"))
    return seconds * 1e3 / ctx.host_plans if seconds > 0 else None
