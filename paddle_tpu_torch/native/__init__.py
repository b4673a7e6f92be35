"""The port's counterpart of ``paddle_tpu/native``: for now only a
reader of the C++ core's binary program format (``ptpf``). The rest of
that package (the XLA builder, ``xla_train``, ``hlo_exec``) has no
libtorch counterpart yet."""
