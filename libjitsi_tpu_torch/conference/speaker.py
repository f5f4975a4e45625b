"""Active-speaker identification (reference:
`org.jitsi.impl.neomedia.ActiveSpeakerDetectorImpl` /
`DominantSpeakerIdentification` — the Volfin & Cohen multi-timescale
algorithm), grown into a top-K ranker for broadcast conferences.

Per 20 ms frame, each participant's audio level (the mixer kernel's
by-product) feeds three exponential time scales — immediate (frame),
medium (~200 ms) and long (~1 s) speech-activity scores.  A speaker
becomes dominant when its long-scale activity beats the incumbent's by
a hysteresis margin across all scales; the decision logic is a few
vectorized array ops over all participants (levels come batched from
the device).

The top-K generalization keeps a STABLE member set of up to `k`
speakers: vacancies fill eagerly, but once full at most one
hysteresis-gated swap happens per tick (the challenger must beat the
weakest member on all three scales by the margin), so the set never
flaps under oscillating levels and downstream row-role flips (the
hierarchical mixing plane treats membership changes as lifecycle
events) stay rare.  With ``k=1`` the member set degenerates exactly to
the classic dominant-speaker trajectory.  All ties are deterministic:
the lowest sid wins promotion, the highest sid loses demotion.

Counterpart: `libjitsi_tpu/conference/speaker.py` (copied; host NumPy).
The scores `immediate`, `medium` and `long` carry over from a JAX
detector by copying the arrays.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

SILENCE_LEVEL = 127  # RFC 6465: 127 dBov down = silence


class DominantSpeakerIdentification:
    def __init__(self, capacity: int = 256,
                 on_change: Optional[Callable[[int], None]] = None,
                 speech_threshold: float = 0.12,
                 margin: float = 1.15,
                 k: int = 1,
                 on_speakers_change: Optional[
                     Callable[[Tuple[int, ...]], None]] = None):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.capacity = capacity
        self.on_change = on_change
        self.on_speakers_change = on_speakers_change
        self.speech_threshold = speech_threshold
        self.margin = margin
        self.k = int(k)
        # activity in [0,1] at three time scales
        self.immediate = np.zeros(capacity)
        self.medium = np.zeros(capacity)
        self.long = np.zeros(capacity)
        self.active = np.zeros(capacity, dtype=bool)
        self._member = np.zeros(capacity, dtype=bool)
        self.dominant: int = -1
        self.promotions = 0
        self.demotions = 0
        self._frames = 0

    # ----------------------------------------------------------- roster

    def add_participant(self, sid: int) -> None:
        self.active[sid] = True
        self.immediate[sid] = self.medium[sid] = self.long[sid] = 0.0

    def remove_participant(self, sid: int) -> None:
        self.active[sid] = False
        if self._member[sid]:
            self._member[sid] = False
            self.demotions += 1
            self._notify_speakers()
        if self.dominant == sid:
            self.dominant = -1

    @property
    def speakers(self) -> Tuple[int, ...]:
        """Current member set, ascending sid (stable across ticks)."""
        return tuple(int(s) for s in np.flatnonzero(self._member))

    # ----------------------------------------------------------- update

    def levels(self, levels: np.ndarray) -> int:
        """Feed one frame tick of per-participant levels (uint8 dBov,
        127 = silence); returns the current dominant sid (-1 none).

        Levels array is indexed by sid (rows beyond len are inactive).
        """
        self._frames += 1
        lv = np.full(self.capacity, SILENCE_LEVEL, dtype=np.float64)
        lv[: len(levels)] = np.asarray(levels, dtype=np.float64)
        # loudness in [0,1]: 0 dBov -> 1, silence -> 0 (perceptual-ish)
        loud = np.clip((70.0 - lv) / 70.0, 0.0, 1.0)
        loud[~self.active] = 0.0
        speaking = loud > self.speech_threshold

        # three exponential scales (time constants ~3 / ~10 / ~50 frames)
        self.immediate += (loud - self.immediate) / 3.0
        self.medium += (speaking * self.immediate - self.medium) / 10.0
        self.long += (self.medium - self.long) / 50.0

        self._decide()
        return self.dominant

    # --------------------------------------------------------- decision

    def _best(self, mask: np.ndarray) -> int:
        """Index of the max `long` under `mask` with `long` > 0, ties
        to the lowest sid (np.argmax); -1 when nothing qualifies."""
        scores = np.where(mask, self.long, -1.0)
        best = int(np.argmax(scores))
        return best if scores[best] > 0 else -1

    def _decide(self) -> None:
        changed = False
        # 1) drop members that left / went inactive
        gone = self._member & ~self.active
        if gone.any():
            self._member &= self.active
            self.demotions += int(np.count_nonzero(gone))
            changed = True
        # 2) fill vacancies eagerly (lowest sid wins ties)
        while int(np.count_nonzero(self._member)) < self.k:
            cand = self._best(self.active & ~self._member)
            if cand < 0:
                break
            self._member[cand] = True
            self.promotions += 1
            changed = True
        # 3) full set: at most ONE hysteresis-gated swap per tick.  The
        #    challenger is the strongest non-member; the victim the
        #    weakest member (ties demote the HIGHEST sid, so the lowest
        #    sid wins at staying).  Challenger must beat the victim on
        #    all three scales — the exact classic rule, so k=1 is the
        #    old dominant-speaker behavior verbatim.
        if int(np.count_nonzero(self._member)) >= self.k:
            ch = self._best(self.active & ~self._member)
            if ch >= 0:
                members = np.flatnonzero(self._member)
                order = np.lexsort((-members, self.long[members]))
                weak = int(members[order[0]])
                if (self.long[ch] > self.margin * self.long[weak]
                        and self.medium[ch] > self.margin
                        * self.medium[weak]
                        and self.immediate[ch] > self.immediate[weak]):
                    self._member[weak] = False
                    self._member[ch] = True
                    self.promotions += 1
                    self.demotions += 1
                    changed = True
        self._decide_dominant()
        if changed:
            self._notify_speakers()

    def _decide_dominant(self) -> None:
        """Lead speaker among members, with the classic single-slot
        hysteresis (incumbent keeps the floor until a fellow member
        beats it on all three scales)."""
        cur = self.dominant
        if cur >= 0 and not self._member[cur]:
            self.dominant = cur = -1
        if cur < 0:
            best = self._best(self._member)
            if best >= 0:
                self._switch(best)
            return
        others = self._member.copy()
        others[cur] = False
        best = self._best(others)
        if best >= 0 and (
                self.long[best] > self.margin * self.long[cur]
                and self.medium[best] > self.margin * self.medium[cur]
                and self.immediate[best] > self.immediate[cur]):
            self._switch(best)

    def _switch(self, sid: int) -> None:
        if sid != self.dominant:
            self.dominant = sid
            if self.on_change is not None:
                self.on_change(sid)

    def _notify_speakers(self) -> None:
        if self.on_speakers_change is not None:
            self.on_speakers_change(self.speakers)
