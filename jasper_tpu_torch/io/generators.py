"""Generator-command fan-in, the -g/-G input mode of `jellyfish count`
(copy of jasper_tpu/io/generators.py:15-79).

The reference forks a manager process that runs each line of a commands file
as a shell command writing into a tmp-dir FIFO consumed by the stream
manager (jellyfish generator_manager.hpp:64-146). Here each command is a
subprocess whose stdout pipe is consumed directly by the parser layer; when
stream i is first read, commands i..i+G-1 are running (the OS pipe buffer
plays the FIFO's role), so up to `n_concurrent` generators produce ahead of
the consumer.

Streams are lazy RawIOBase objects: nothing spawns until the first read, so
they can be collected/listed safely before consumption. They are parsed by
the Python parser (count/counter.py:parse_chunks).
"""

from __future__ import annotations

import io
import os
import subprocess


class _GenStream(io.RawIOBase):
    def __init__(self, mgr: "GeneratorManager", idx: int):
        super().__init__()
        self.mgr = mgr
        self.idx = idx
        self._done = False

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        if self._done:
            return 0
        f = self.mgr._ensure(self.idx)
        n = f.readinto(b)
        if n == 0:
            self._done = True
            self.mgr._finish(self.idx)
        return n


class GeneratorManager:
    def __init__(self, commands_path: str, n_concurrent: int = 1,
                 shell: str | None = None):
        """shell: explicit shell binary for the commands (jellyfish -S /
        --shell); default $SHELL, falling back to /bin/sh — the reference
        generator_manager's resolution order (generator_manager.hpp:112-121).
        """
        with open(commands_path) as f:
            self.commands = [line.strip() for line in f if line.strip()]
        self.n = max(1, int(n_concurrent))
        self.shell = shell or os.environ.get("SHELL") or "/bin/sh"
        self._procs: dict[int, subprocess.Popen] = {}

    def streams(self) -> list:
        """One lazy readable stream per command, in file order."""
        return [io.BufferedReader(_GenStream(self, i)) for i in range(len(self.commands))]

    def _ensure(self, idx: int):
        # keep the window [idx, idx + n) of generators running
        for j in range(idx, min(idx + self.n, len(self.commands))):
            if j not in self._procs:
                self._procs[j] = subprocess.Popen(
                    [self.shell, "-c", self.commands[j]],
                    stdout=subprocess.PIPE,
                )
        return self._procs[idx].stdout

    def _finish(self, idx: int) -> None:
        proc = self._procs.get(idx)
        if proc is not None and proc.returncode is None:
            proc.stdout.close()
            rc = proc.wait()
            if rc != 0:
                raise RuntimeError(
                    f"generator command {self.commands[idx]!r} exited with {rc}"
                )
