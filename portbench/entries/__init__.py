"""Traffic drivers, one module an entry point of `repro_torch.fft`, found by
the ``entry`` a traffic file names. Each defines ``Driver(ctx)`` with
``kind`` (the transform, c2c or r2c), ``in_bytes`` (the signal one call
transforms), ``call(i)`` (issue call i, not waited for), optionally
``complete(out)`` (the call's own wait, returning its output), and
``check(i, out)`` and ``control(i)`` (the numbers compared for call i's
output, and for the control in the program's place)."""
