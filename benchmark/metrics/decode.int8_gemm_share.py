"""The share of the device's time in the int8 GEMMs of the convs
(``torch._int_mm``). A graph replay links no kernel to its operator, so
the set-up of a traced run learns the GEMM kernels' names: it profiles one
eager ``torch._int_mm`` at each conv's GEMM shape of the cell's tile."""

from counts.decode import int8_gemm_shapes


def prepare(run):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = run.device
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    names = set()
    for m, k, n in int8_gemm_shapes(run.settings, int(run.cell["tile"])):
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev)
        b = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev)
        torch._int_mm(a, b.t())
        sync()
        with profile(activities=[activity]) as prof:
            torch._int_mm(a, b.t())
            sync()
        names |= {e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(("Memset", "Memcpy"))}
    run.extra["int8_gemm_kernels"] = names


def read(run):
    names = run.extra.get("int8_gemm_kernels")
    if run.trace is None or not names or run.trace.device_s <= 0:
        return None
    return 100.0 * run.trace.seconds(lambda n: n in names) / run.trace.device_s
