"""`replay_share.train`: per cent of the traced window's `trainer.step` root
spans that hold a `trainer.replay` child (the step replayed from its CUDA
graph); None where the window holds no `trainer.replay` span, as in a
program without the captured step."""

from __future__ import annotations

from typing import Optional

from benchlib.spans import view


def read(ctx) -> Optional[float]:
    v = view(ctx)
    if v is None:
        return None
    replayed = {sp[4] for sp in v.of("trainer.replay")}
    steps = [sp for sp in v.of("trainer.step") if sp[4] is None]
    if not replayed or not steps:
        return None
    return 100.0 * sum(sp[0] in replayed for sp in steps) / len(steps)
