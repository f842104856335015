"""Shared driver plumbing: output cadence, VTK/dat emission, MLUPS report."""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..io.loggers import DatLogger, MlupsClock
from ..io.vtk import VtkWriter, sol_filename


class Driver:
    """Replicates the reference drivers' loop skeleton: periodic VTK dumps,
    periodic stdout + .dat logging, end-of-run MLUPS line (e.g.
    laplace2D.h:485-511).

    VTK dumps are ASYNCHRONOUS by default (``async_io=True``): the device
    arrays' host copies are started eagerly (``copy_to_host_async``), then
    formatting and disk write run on a single worker thread while the main
    thread enqueues the next device chunk, so the device does not wait on
    formatting and disk writes; the reference pays them inline every dump
    (e.g. ``PulsatileBloodFlow2D.h:680-705`` serializes 103 dumps on the
    time loop).  In-flight dumps are bounded to 2 so a
    3D run can't accumulate gigabytes of host staging.  ``finish()``
    drains the queue and re-raises the first worker error, so files are
    complete (and failures loud) before the MLUPS line prints.  JAX
    arrays are immutable and the models never donate buffers, so a
    snapshot handed to the worker cannot be mutated by later steps."""

    def __init__(self, outdir, nelem, out_freq=0, vtk_freq=0,
                 async_io=True):
        self.outdir = Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.out_freq = out_freq
        self.vtk_freq = vtk_freq
        self.clock = MlupsClock(nelem)
        self._logs = {}
        self.async_io = async_io
        self._pool = None
        self._writes = []
        self._io_err = None

    def log_file(self, name) -> DatLogger:
        if name not in self._logs:
            self._logs[name] = DatLogger(self.outdir / name)
        return self._logs[name]

    def want_vtk(self, it) -> bool:
        return self.vtk_freq != 0 and it % self.vtk_freq == 0

    def want_out(self, it) -> bool:
        return self.out_freq != 0 and it % self.out_freq == 0

    def write_vtk(self, it, nx, ny, nz=1, spacing=1.0, scalars=(), vectors=(),
                  int_scalars=()):
        if not self.async_io:
            self._do_write(it, nx, ny, nz, spacing, scalars, vectors,
                           int_scalars)
            return
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="vtk-io")
        # enforce the in-flight bound BEFORE staging this dump's copies, so
        # at most 2 snapshots are ever held (executing + queued) — staging
        # first would transiently pin a third field set
        while len(self._writes) >= 2:
            try:
                self._writes.pop(0).result()
            except Exception as e:
                # defer to drain()/finish(): raising from inside the time
                # loop would leave the remaining queued future and the pool
                # undrained (runners don't call finish() in a finally)
                if self._io_err is None:
                    self._io_err = e
        # start every device->host copy now (non-blocking), then hand the
        # formatting + disk write to the worker
        for _, data in (*scalars, *vectors, *int_scalars):
            start = getattr(data, "copy_to_host_async", None)
            if start is not None:
                start()
        self._writes.append(self._pool.submit(
            self._do_write, it, nx, ny, nz, spacing, tuple(scalars),
            tuple(vectors), tuple(int_scalars)))

    def _do_write(self, it, nx, ny, nz, spacing, scalars, vectors,
                  int_scalars):
        w = VtkWriter(nx, ny, nz, spacing=spacing, iteration=it)
        for name, data in scalars:
            w.scalar(name, np.asarray(data))
        for name, data in vectors:
            w.vector(name, np.asarray(data))
        for name, data in int_scalars:
            w.scalar(name, np.asarray(data), as_int=True)
        w.write(self.outdir / sol_filename(it))

    def drain(self):
        """Block until ALL queued dumps are on disk; then re-raise the
        first worker error (a silently dropped dump must not look like
        success — and a later dump's failure must not be masked by an
        earlier one: every future is awaited before raising)."""
        writes, self._writes = self._writes, []
        first_err, self._io_err = self._io_err, None
        for fut in writes:
            try:
                fut.result()
            except Exception as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    def finish(self):
        # even on a failed dump, release the worker thread and flush/close
        # the .dat logs before propagating
        try:
            self.drain()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None
            for lg in self._logs.values():
                lg.close()
        print(self.clock.report())
        return self.clock.mlups


def next_chunk(it, steps, *freqs):
    """Steps to advance from ``it`` so the loop lands exactly on the next
    diagnostic event: the smallest distance to a multiple of any nonzero
    cadence, bounded by the end of the run.  A fixed stride of one cadence
    silently skips the other's instants whenever they aren't multiples of
    each other (e.g. out_freq=400, vtk_freq=1000 → dumps at 1000/3000
    never land)."""
    dists = [f - it % f for f in freqs if f]
    return max(1, min([steps - it] + dists))
