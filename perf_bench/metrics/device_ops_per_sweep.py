"""device_ops_per_sweep (ops/sweep): the device operations (hand kernels,
PyTorch kernels, copies and sets) that start inside the traced jobs, per
sweep those jobs ran: the glue around the hand kernels that fusion or CUDA
graphs would cut.  Layer: the engine.  Moves updates_per_s."""


def read(tl):
    ops = tl.device_ops()
    if not ops or tl.sweeps <= 0:
        return None
    return len(ops) / tl.sweeps
