"""Demo CLI: build/play a service and dump decoded output (the port of
espflix_tpu/tools/play.py).

    python -m espflix_tpu_torch.tools.play --make-service SVC
    python -m espflix_tpu_torch.tools.play --root file://SVC --title 0 \
        --frames 8 --out OUT   [--field] [--pal] [--ff | --rwd] \
        [--device cuda|cpu]

Dumps decoded YUV frames as PGM files (y/u/v planes) and optionally the
synthesized composite field, so a change can be SEEN end-to-end.  The
fleet's tick and OutputStage.synthesize run on --device (the card by
default); the planes and fields are written from host copies.
"""

from __future__ import annotations

import argparse
import os
import sys


def write_pgm(path: str, a):
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (a.shape[1], a.shape[0]))
        f.write(a.tobytes())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--make-service", metavar="DIR")
    ap.add_argument("--titles", type=int, default=1)
    ap.add_argument("--root")
    ap.add_argument("--title", type=int, default=0)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default="play_out")
    ap.add_argument("--field", action="store_true",
                    help="also dump composite fields")
    ap.add_argument("--pal", action="store_true")
    ap.add_argument("--ff", action="store_true")
    ap.add_argument("--rwd", action="store_true")
    ap.add_argument("--seek", type=float, default=0.0,
                    help="start position in seconds")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the fleet and the output stage")
    args = ap.parse_args(argv)

    if args.make_service:
        from espflix_tpu_torch.tools.indexer import make_service

        names = [f"title{i}" for i in range(args.titles)]
        make_service(args.make_service, names, seed=1)
        print(f"service written to {args.make_service}: {names}")
        if not args.root:
            return 0

    if not args.root:
        ap.error("--root required to play")

    from espflix_tpu_torch.runtime.output import OutputStage
    from espflix_tpu_torch.runtime.player import PlayerSession, State
    from espflix_tpu_torch.runtime.scheduler import Fleet

    s = PlayerSession(args.root)
    if not s.init_service():
        print("can't reach service", file=sys.stderr)
        return 1
    s.nav(args.title)
    if args.seek:
        s.info[args.title].pos = int(args.seek * 90000)
    if args.ff:
        s.fast_forward()
    elif args.rwd:
        s.rewind()
    else:
        s.play_pause()

    fleet = Fleet(1, words_per_lane=16384, device=args.device)
    fleet.attach(0, s)
    out_stage = (OutputStage(1, pal=args.pal, device=args.device)
                 if args.field else None)
    if out_stage:
        out_stage.show_progress(0)

    os.makedirs(args.out, exist_ok=True)
    n = 0
    while n < args.frames and s.state != State.DONE:
        # planes stay on the device for the output stage
        r = fleet.tick(fetch_frames=False)
        if not r.video_lanes[0]:
            continue
        write_pgm(f"{args.out}/frame{n:03d}_y.pgm", r.y[0].cpu().numpy())
        write_pgm(f"{args.out}/frame{n:03d}_u.pgm", r.u[0].cpu().numpy())
        write_pgm(f"{args.out}/frame{n:03d}_v.pgm", r.v[0].cpu().numpy())
        if out_stage:
            ti = s.info.get(s.nav_index)
            if ti and ti.idx_hdr:
                out_stage.update_progress(
                    0, ti.pos, ti.idx_hdr.video.last_pts,
                    out_stage.icon_for(s.speed, False))
            fields = out_stage.synthesize(r.y, r.u, r.v)
            write_pgm(f"{args.out}/field{n:03d}.pgm",
                      (fields[0].cpu().numpy().astype("float32") * 2.5)
                      .clip(0, 255).astype("uint8"))
        n += 1
    print(f"wrote {n} frames to {args.out} "
          f"(state={s.state.name}, pts={s.last_pts})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
