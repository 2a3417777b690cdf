"""One file a kernel wrapper of the port: WRAPPER = (module, function),
and work(arguments) -> {"flops", "bytes", "rate"} of one call from its
bound arguments (`roofline.bound_s`), or None where no formula is kept.
The formulas are those of the port's `chip_smoke.py` and `PERF.md`'s
kernel table: each input byte read once, each output byte written once."""
