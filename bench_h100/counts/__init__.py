"""A configuration's own counts: ``counts/<config>.py``, found by name
(``spec.counts``) and loaded by path. It may define any of

* ``prefill_flops(run, batch, seq)``: model FLOPs of one prefill;
* ``train_flops(run, batch, seq)``: model FLOPs of one train step;
* ``flash_bound_s(run, batch, seq)``: B6's least time for all the
  flash-attention launches of one forward (0 where no layer attends);

each of a configuration file's ``run`` sizes and a request's or a step's
shape. What a file leaves out comes from ``flops.py``, which counts every
layer as attention and an MLP or top-k experts: right for the dense and
moe families, wrong for a layer of any other kind.
"""
