"""Track reactions (like/favourite) subsystem.

Parity target: OpenHome/Av/Reactions.h (IReactionHandler /
IFavouritesHandler / IFavouritesReactionHandler) and
Av/ProviderReaction.cpp — the Reaction service lets control points
attach a reaction ("love" / favourite) to the currently playing track;
service integrations (e.g. the Tidal/Qobuz favourites endpoints) act as
the handlers.  AvailableReactions is a JSON array string, empty "[]"
when the current track is not reactable (ProviderReaction.cpp:17).
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Optional

ERR_NO_CURRENT_TRACK = 801
ERR_TRACK_NOT_REACTABLE = 802


class ReactionError(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


class ReactionHandler:
    """One source of reactions (Reactions.h IReactionHandler).

    `current_reaction_state(uri)` returns (handled, can_react,
    current_reaction, available_reactions-list); a handler that does
    not recognise the uri returns handled=False and the registry moves
    on to the next handler."""

    def __init__(self):
        self._observers: list[Callable[[], None]] = []

    def add_observer(self, cb: Callable[[], None]) -> None:
        self._observers.append(cb)

    def notify_state_changed(self) -> None:
        for cb in list(self._observers):
            cb()

    # -- override points -------------------------------------------------
    def current_reaction_state(self, uri: str):
        return False, False, "", []

    def set_reaction(self, uri: str, reaction: str) -> bool:
        return False

    def clear_reaction(self, uri: str) -> bool:
        return False


class FavouritesReactionHandler(ReactionHandler):
    """Adapts a favourites backend (favorite_track/unfavorite_track,
    Reactions.h IFavouritesHandler) into a one-reaction handler — the
    reference's FavouriteStatus eFavourite/eUnfavourite model.

    `uri_filter` bounds the handler to its service's tracks (a Tidal
    handler must not claim file:// uris)."""

    REACTION = "love"

    def __init__(self, favourites, uri_filter: Callable[[str], bool]):
        super().__init__()
        self._fav = favourites
        self._filter = uri_filter
        self._state: dict[str, bool] = {}

    def current_reaction_state(self, uri: str):
        if not self._filter(uri):
            return False, False, "", []
        cur = self.REACTION if self._state.get(uri) else ""
        return True, True, cur, [self.REACTION]

    def set_reaction(self, uri: str, reaction: str) -> bool:
        if not self._filter(uri) or reaction != self.REACTION:
            return False
        if self._fav.favorite_track(uri):
            self._state[uri] = True
            self.notify_state_changed()
            return True
        return False

    def clear_reaction(self, uri: str) -> bool:
        if not self._filter(uri):
            return False
        if self._fav.unfavorite_track(uri):
            self._state[uri] = False
            self.notify_state_changed()
            return True
        return False


class ReactionRegistry:
    """ProviderReaction's model half: tracks the current pipeline
    track, queries the registered handlers for its reaction state and
    dispatches Set/Clear to every handler (ProviderReaction.cpp
    GetNewHandlerReactionStateLocked / SetReaction / ClearReaction)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._handlers: list[ReactionHandler] = []
        self._uri: Optional[str] = None
        self._observers: list[Callable[[], None]] = []
        self.can_react = False
        self.current_reaction = ""
        self.available_reactions = "[]"

    def add_handler(self, handler: ReactionHandler) -> None:
        with self._lock:
            handler.add_observer(self._refresh)
            self._handlers.append(handler)
        self._refresh()

    def add_observer(self, cb: Callable[[], None]) -> None:
        self._observers.append(cb)

    # called from the pipeline observer spine
    def notify_track(self, track, start_of_stream: bool = False) -> None:
        with self._lock:
            self._uri = track.uri
        self._refresh()

    def _refresh(self) -> None:
        with self._lock:
            can, cur, avail = False, "", []
            if self._uri is not None:
                for h in self._handlers:
                    handled, can, cur, avail = \
                        h.current_reaction_state(self._uri)
                    if handled:
                        break
                    can, cur, avail = False, "", []
            self.can_react = bool(can)
            self.current_reaction = cur
            self.available_reactions = json.dumps(avail)
        for cb in list(self._observers):
            cb()

    def set_reaction(self, reaction: str) -> None:
        with self._lock:
            uri = self._uri
            handlers = list(self._handlers)
        if uri is None:
            raise ReactionError(ERR_NO_CURRENT_TRACK, "no current track")
        handled = False
        for h in handlers:
            if reaction == "":
                handled |= h.clear_reaction(uri)
            else:
                handled |= h.set_reaction(uri, reaction)
        if not handled:
            raise ReactionError(ERR_TRACK_NOT_REACTABLE,
                                "track not reactable")
        self._refresh()

    def clear_reaction(self) -> None:
        with self._lock:
            uri = self._uri
            handlers = list(self._handlers)
        if uri is None:
            raise ReactionError(ERR_NO_CURRENT_TRACK, "no current track")
        handled = False
        for h in handlers:
            handled |= h.clear_reaction(uri)
        if not handled:
            raise ReactionError(ERR_TRACK_NOT_REACTABLE,
                                "track not reactable")
        self._refresh()
