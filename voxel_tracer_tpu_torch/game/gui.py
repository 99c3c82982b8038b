"""Game GUI screens (src/game/gui.h + game.cpp:103-223 analog, headless).

The reference draws its menu / score HUD / game-over screens with ImGui
helpers (centered text, centered buttons, fullscreen overlay tint,
gui.h:1-67) from `Game::gui()` (game.cpp:103-223).  Headless equivalent:
the same screens composited onto the framebuffer `Surface` with its
glyph printer, plus keyboard-driven button focus/activation in place of
mouse clicks.  `draw_game_gui` dispatches on the Game's state machine
exactly like Game::gui's switch.
"""

from __future__ import annotations

import dataclasses

from voxel_tracer_tpu_torch.game.game import Game, GameState
from voxel_tracer_tpu_torch.utils.framebuffer import Surface

_GLYPH_W = 6      # framebuffer glyph cell (5px + 1 spacing)
_GLYPH_H = 8


def centered_text(surf: Surface, text: str, y: int,
                  color=(255, 255, 255), scale: int = 1):
    """gui.h centered-text analog: x centered on the surface width."""
    w = len(text) * _GLYPH_W * scale
    surf.print(text, max(0, (surf.width - w) // 2), y, color, scale=scale)


def overlay(surf: Surface, color=(0, 0, 0), alpha: float = 0.5):
    """Fullscreen tint (gui.h overlay analog): blend color over the
    frame — the reference dims the 3D view behind menu screens."""
    import numpy as np
    c = np.asarray(color, np.float32)
    surf.pixels[:] = (surf.pixels.astype(np.float32) * (1.0 - alpha)
                      + c * alpha).astype(np.uint8)


def button(surf: Surface, label: str, y: int, focused: bool,
           scale: int = 1):
    """Centered button (gui.h centered-button analog): a boxed label;
    focus is drawn as a filled bar (keyboard focus replaces hover)."""
    w = len(label) * _GLYPH_W * scale + 12
    h = _GLYPH_H * scale + 8
    x0 = (surf.width - w) // 2
    y0 = y
    if focused:
        surf.bar(x0, y0, x0 + w, y0 + h, (70, 70, 110))
    surf.box(x0, y0, x0 + w, y0 + h, (255, 255, 255))
    centered_text(surf, label, y0 + 4,
                  (255, 255, 120) if focused else (200, 200, 200), scale)


@dataclasses.dataclass
class MenuInput:
    """Keyboard menu input: replaces the reference's mouse clicks."""

    up: bool = False
    down: bool = False
    confirm: bool = False


class GameGui:
    """Menu focus state + per-state screen compositing (Game::gui)."""

    MENU_ITEMS = ("PLAY", "QUIT")
    OVER_ITEMS = ("RETRY", "MENU")

    def __init__(self):
        self.focus = 0
        self.quit_requested = False

    def _nav(self, items, inp: MenuInput) -> str | None:
        if inp.up:
            self.focus = (self.focus - 1) % len(items)
        if inp.down:
            self.focus = (self.focus + 1) % len(items)
        return items[self.focus] if inp.confirm else None

    def tick(self, game: Game, inp: MenuInput):
        """Advance menu state from input; mirrors the button handlers in
        game.cpp's MENU/GAMEOVER blocks (play -> start, retry -> start,
        menu -> back to MENU, quit -> flag)."""
        if game.state == GameState.MENU:
            hit = self._nav(self.MENU_ITEMS, inp)
            if hit == "PLAY":
                game.start()
                self.focus = 0
            elif hit == "QUIT":
                self.quit_requested = True
        elif game.state == GameState.GAME_OVER:
            hit = self._nav(self.OVER_ITEMS, inp)
            if hit == "RETRY":
                game.start()
                self.focus = 0
            elif hit == "MENU":
                game.state = GameState.MENU
                self.focus = 0

    def draw(self, surf: Surface, game: Game):
        """Composite the current state's screen (Game::gui switch)."""
        h = surf.height
        if game.state == GameState.MENU:
            overlay(surf, (10, 10, 30), 0.6)
            centered_text(surf, "VOXEL TRACER", h // 4, (255, 255, 255), 2)
            for i, label in enumerate(self.MENU_ITEMS):
                button(surf, label, h // 2 + i * (_GLYPH_H + 14),
                       self.focus == i)
        elif game.state == GameState.GAME:
            # in-game HUD: score + time (game.cpp:134-143)
            for i, line in enumerate(game.hud_lines()):
                surf.print(line, 4, 4 + i * (_GLYPH_H + 2))
        else:  # GAME_OVER
            overlay(surf, (40, 0, 0), 0.6)
            centered_text(surf, "GAME OVER", h // 4, (255, 80, 80), 2)
            centered_text(surf, f"SCORE {game.score}",
                          h // 4 + 2 * _GLYPH_H + 6, (255, 255, 255))
            for i, label in enumerate(self.OVER_ITEMS):
                button(surf, label, h // 2 + i * (_GLYPH_H + 14),
                       self.focus == i)


def draw_game_gui(surf: Surface, game: Game, gui: GameGui,
                  inp: MenuInput | None = None):
    """One GUI frame: optional input tick + state-dispatched draw."""
    if inp is not None:
        gui.tick(game, inp)
    gui.draw(surf, game)
    return surf
