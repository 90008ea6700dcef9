"""TCP debug shell (the ohNet Shell the reference builds its debug
tooling on, plus the command handlers ohPipeline registers against it).

Parity targets: ohNet's Shell (an external dependency of the
reference; a TCP line server on port 2323 with registered per-command
handlers, built-in `help` and `quit` — see its uses at
/root/reference/OpenHome/Media/Tests/TestShell.cpp:12-34) and the
reference handlers:

* LoggerBuffered's `log print` — dumps the ring-buffered log
  (/root/reference/OpenHome/Av/Logger.cpp:82-133);
* ClockPullerManual's manual clock-pull command
  (/root/reference/OpenHome/Media/Utils/ClockPullerManual.h:13-26);
* the `pipeline` buffer-occupancy numbers ProviderDebug/LogBuffers
  also exposes (net/providers.make_debug_service).

Handlers follow the reference shape: a callable taking the argument
list and returning the response text (IShellCommandHandler::
HandleShellCommand writing to IWriter), plus a help line
(DisplayHelp).  Unknown commands and handler exceptions answer on the
connection instead of killing the session, matching the reference's
session loop.
"""

from __future__ import annotations

import socket
import socketserver
import threading
from typing import Callable, Optional

#: ohNet Shell::kServerPortDefault
DEFAULT_PORT = 2323


class ShellCommand:
    def __init__(self, name: str, handler: Callable[[list], str],
                 help_text: str):
        self.name = name
        self.handler = handler
        self.help_text = help_text


class Shell:
    """Line-oriented TCP command server: one command per line
    (`name arg1 arg2 ...`), response text then a `> ` prompt; `help`
    lists registered commands, `quit` ends the session."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._commands: dict[str, ShellCommand] = {}
        self._lock = threading.RLock()
        shell = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                self.wfile.write(b"ohpipeline shell\n> ")
                for raw in self.rfile:
                    line = raw.decode("utf-8", "replace").strip()
                    if not line:
                        self.wfile.write(b"> ")
                        continue
                    parts = line.split()
                    name, args = parts[0], parts[1:]
                    if name == "quit":
                        self.wfile.write(b"bye\n")
                        return
                    out = shell._dispatch(name, args)
                    if not out.endswith("\n"):
                        out += "\n"
                    self.wfile.write(out.encode("utf-8", "replace") + b"> ")

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    # -- command registry (IShell::AddCommandHandler) -----------------------
    def add_command(self, name: str, handler: Callable[[list], str],
                    help_text: str) -> None:
        with self._lock:
            self._commands[name] = ShellCommand(name, handler, help_text)

    def remove_command(self, name: str) -> None:
        with self._lock:
            self._commands.pop(name, None)

    def _dispatch(self, name: str, args: list) -> str:
        if name == "help":
            with self._lock:
                cmds = sorted(self._commands.values(),
                              key=lambda c: c.name)
            lines = ["help", "  list commands", "quit",
                     "  close this session"]
            for c in cmds:
                lines += [c.name, "  " + c.help_text]
            return "\n".join(lines)
        with self._lock:
            cmd = self._commands.get(name)
        if cmd is None:
            return f"Unknown command: {name} (try 'help')"
        try:
            return cmd.handler(args)
        except Exception as e:          # session survives handler faults
            return f"error: {e}"

    # -- lifecycle -----------------------------------------------------------
    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="shell", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            # never started: shutdown() would block forever on the
            # event only serve_forever() sets; just release the socket
            self._server.server_close()
            return
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)

    # context manager sugar for tests
    def __enter__(self) -> "Shell":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def run_command(host: str, port: int, line: str,
                timeout: float = 5.0) -> str:
    """One-shot client: send a command line, return the response text
    (without the prompt).

    The wire protocol is the reference shell's human-oriented raw TCP
    (response text then a ``> `` prompt), so a response that itself
    contains a line starting with ``> `` is ambiguous to naive clients
    and would be truncated here — same limitation as telnetting the
    ohNet shell."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        f = s.makefile("rwb")
        # greeting + first prompt
        f.readline()
        _read_prompt(f)
        f.write(line.encode() + b"\n")
        f.flush()
        out = _read_until_prompt(f)
        f.write(b"quit\n")
        f.flush()
        return out


def _read_prompt(f) -> None:
    while f.read(1) not in (b">", b""):
        pass
    f.read(1)                            # the space


def _read_until_prompt(f) -> str:
    buf = b""
    while True:
        ch = f.read(1)
        if not ch:
            break
        buf += ch
        if buf.endswith(b"\n> "):
            return buf[:-3].decode("utf-8", "replace")
    return buf.decode("utf-8", "replace")


def attach_media_player(shell: Shell, mp) -> None:
    """Register the ohPipeline command set against a MediaPlayer (the
    handlers MediaPlayer/LoggerBuffered/ClockPullerManual add in the
    reference)."""

    def log_cmd(args):
        if args != ["print"]:
            return "Unexpected command for 'log' (want: log print)"
        return mp.log.dump()

    shell.add_command("log", log_cmd,
                      "log print: display all recently logged content")

    def pipeline_cmd(args):
        pipe = mp.pipeline.pipeline
        return (f"encoded_bytes={pipe.encoded.occupancy} "
                f"decoded_jiffies={pipe.decoded.occupancy}")

    shell.add_command("pipeline", pipeline_cmd,
                      "pipeline: reservoir occupancy")

    def info_cmd(args):
        prod = mp.product
        src = prod.current_source()
        return (f"room={prod.room} name={prod.name} "
                f"standby={prod.standby} "
                f"source={src.name if src else '-'}")

    shell.add_command("info", info_cmd, "info: product state")

    def sources_cmd(args):
        prod = mp.product
        cur = prod.source_index()
        return "\n".join(
            f"{'*' if i == cur else ' '} {i} {prod.source(i).name}"
            for i in range(prod.source_count()))

    shell.add_command("sources", sources_cmd,
                      "sources: list sources (* = current)")

    def volume_cmd(args):
        if args:
            mp.volumes.set_volume(int(args[0]))
        return str(mp.volumes.volume)

    shell.add_command("volume", volume_cmd,
                      "volume [n]: get/set the user volume")
