"""The message kernels' share of their roofline: ``context_ell`` (and, in
training, Eq. 7's ``w_t`` form) and ``spmm_ell`` (and its transpose),
the least time of their traced launches (``bench/roofline.py``, counted
by the backbone's ``message_least_s``) over their device time.  Nothing
to read where the backbone has no such kernels (GAT)."""


def read(r):
    least = r.work.get("message_least_s")
    dev = r.trace.device_s("context_ell", "spmm_ell")
    return least / dev * 100 if least and dev > 0 else None
