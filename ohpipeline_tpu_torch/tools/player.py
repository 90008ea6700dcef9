"""Runnable media renderer — the full-app harness, on the card.

Parity target: Av/Tests/TestMediaPlayer.h:124 (complete renderer with RAM
store, all sources, AnimatorBasic) + TestMediaPlayerOptions CLI flags +
the ohNet Shell debug commands (Media/Tests/TestShell).

The port's counterpart of the JAX package's ``tools/player.py``: the same
flags and wiring (a MediaPlayer with its pins, the ODP server on the player's
device, the web config app, the mDNS announcement, an AnimatorBasic or
AnimatorBatch and the shell commands), with the player's pipeline and its
animator's gain pass on ``--device`` (default "cuda"; ``--cpu`` is
``--device cpu``).  Without a card a player that names no device raises
``KernelError`` before anything is built; nothing falls back to the CPU.
The WAV it writes has a 44100 Hz / 16-bit header whatever the stream, as
the JAX player's has.

Usage:
  python -m ohpipeline_tpu_torch.tools.player --room Den --name Box \
      [--uri tone://sine.wav?duration=5] [--wav out.wav] [--realtime]
      [--odp-port N] [--web-port N] [--shell] [--device cuda | --cpu]

With --shell an interactive prompt accepts:
  play/pause/stop | uri <x> | vol <n> | mute/unmute | info | sources |
  source <name> | pins | pin <n> | quit
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--room", default="Main Room")
    ap.add_argument("--name", default="ohpipeline-tpu")
    ap.add_argument("--uri", default="")
    ap.add_argument("--wav", default="", help="write output to a WAV file")
    ap.add_argument("--realtime", action="store_true",
                    help="cadenced animator instead of free-running")
    ap.add_argument("--store", default="", help="persistent store path")
    ap.add_argument("--odp-port", type=int, default=0)
    ap.add_argument("--web-port", type=int, default=0)
    ap.add_argument("--shell", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the pipeline decodes and the gain pass runs")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    args = ap.parse_args(argv)

    from .. import _kernels
    device = _kernels.checked_device("cpu" if args.cpu else args.device)

    from ..av import MediaPlayer, MediaPlayerInitParams
    from ..host.av.pins import (PinsManager, TransportPinInvoker,
                                UrlPinInvoker)
    from ..host.codecs.wav import write_wav
    from ..host.net.mdns import MdnsResponder, announce_media_player
    from ..host.net.odp import OdpServer
    from ..host.net.providers import make_device
    from ..host.net.webapp import ConfigApp, WebAppFramework
    from ..pipeline import AnimatorBasic, AnimatorBatch

    mp = MediaPlayer(MediaPlayerInitParams(room=args.room, name=args.name,
                                           store_path=args.store or None),
                     device=device)
    pins = PinsManager(mp.store)
    pins.add_invoker(TransportPinInvoker(mp.pipeline))
    pins.add_invoker(UrlPinInvoker(mp.pipeline))
    mp.start()

    odp = OdpServer(port=args.odp_port)
    odp.add_device(make_device(mp))
    web = WebAppFramework(port=args.web_port)
    web.add_app(ConfigApp(mp.config))
    web.start()
    mdns = MdnsResponder()
    announce_media_player(mdns, f"{args.room}:{args.name}",
                          odp_port=odp.port, web_port=web.port)
    print(f"[player] {args.room}:{args.name}  odp={odp.port} "
          f"web=http://127.0.0.1:{web.port}/config/ device={mp.device}")

    # sink: WAV file or stats
    wav_chunks: list[np.ndarray] = []
    stats = {"samples": 0}

    def sink(samples, info):
        stats["samples"] += samples.shape[1]
        if args.wav:
            wav_chunks.append(samples)

    try:
        upstream = mp.pipeline.pipeline.predriver
        animator = (AnimatorBasic(upstream, sink, device=mp.device)
                    if args.realtime else
                    AnimatorBatch(upstream, sink, device=mp.device))
        if args.realtime:
            animator.start()

        if args.uri:
            mp.pipeline.play_uri(args.uri)

        if args.shell:
            _shell(mp, pins, stats)
        elif not args.realtime:
            animator.run()
        else:
            try:
                while animator.is_alive():
                    time.sleep(1)
            except KeyboardInterrupt:
                pass
            animator.quit()
            animator.join(10.0)

        if args.wav and wav_chunks:
            pcm = np.concatenate(wav_chunks, axis=1)
            with open(args.wav, "wb") as f:
                f.write(write_wav(pcm, 44100, 16))
            print(f"[player] wrote {pcm.shape[1]} samples to {args.wav}")
        print(f"[player] rendered {stats['samples']} samples")
    finally:
        mdns.close()
        odp.close()
        web.close()
        mp.quit()
    return 0


def _shell(mp, pins, stats) -> None:
    """Debug shell (reference TestShell commands)."""
    print("shell ready; 'help' for commands")
    while True:
        try:
            line = input("oh> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not line:
            continue
        cmd, *rest = line.split(None, 1)
        arg = rest[0] if rest else ""
        try:
            if cmd == "help":
                print("play pause stop uri vol mute unmute info sources "
                      "source pins pin memory quit")
            elif cmd == "play":
                mp.pipeline.play()
            elif cmd == "pause":
                mp.pipeline.pause()
            elif cmd == "stop":
                mp.pipeline.stop()
            elif cmd == "uri":
                mp.pipeline.play_uri(arg)
            elif cmd == "vol":
                mp.volumes.set_volume(int(arg))
            elif cmd == "mute":
                mp.volumes.mute()
            elif cmd == "unmute":
                mp.volumes.unmute()
            elif cmd == "info":
                print(f"state={mp.pipeline.pipeline.state.value} "
                      f"vol={mp.volumes.volume} muted={mp.volumes.muted} "
                      f"samples={stats['samples']}")
            elif cmd == "sources":
                for i in range(mp.product.source_count()):
                    s = mp.product.source(i)
                    cur = "*" if i == mp.product.source_index() else " "
                    print(f"{cur} {i}: {s.system_name} ({s.type})")
            elif cmd == "source":
                mp.product.set_source_by_name(arg)
            elif cmd == "pins":
                for i, p in enumerate(pins.id_array()):
                    print(i, p)
            elif cmd == "pin":
                pins.invoke(int(arg))
            elif cmd == "memory":
                import resource
                kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                print(f"maxrss={kb // 1024} MB")
            elif cmd == "quit":
                break
            else:
                print(f"unknown command {cmd!r}")
        except Exception as e:                             # noqa: BLE001
            print(f"error: {type(e).__name__}: {e}")


if __name__ == "__main__":
    sys.exit(main())
