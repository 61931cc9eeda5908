"""Site content records behind the web front-end: news posts, events,
screenshots + map tiles.

Parity targets: server/NewsPost.h + webserver/NewsPostHandlers.cpp,
server/SubEvent.h + webserver/SubEventHandlers.cpp,
server/Screenshot.h + webserver/ScreenshotHandlers.cpp (incl. the map-tile
variants the screenshot bot produces, Server.cpp tile dispatch).

A copy of ``substrata_tpu/server_side/site_data.py`` with the port's imports: importing
any module of the reference package loads jax, so the port keeps its own.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass(eq=False)
class NewsPost:
    """server/NewsPost.h: markdown-ish site news with publish state."""

    post_id: int = 0
    creator_id: int = 0
    title: str = ""
    content: str = ""
    thumbnail_url: str = ""
    created_time: float = field(default_factory=time.time)
    last_modified_time: float = field(default_factory=time.time)
    published: bool = False


@dataclass(eq=False)
class SubEvent:
    """server/SubEvent.h: an in-world event with a time window and
    attendance list."""

    STATE_DRAFT = 0
    STATE_PUBLISHED = 1
    STATE_DELETED = 2

    event_id: int = 0
    creator_id: int = 0
    world_name: str = ""
    title: str = ""
    description: str = ""
    start_time: float = 0.0
    end_time: float = 0.0
    created_time: float = field(default_factory=time.time)
    last_modified_time: float = field(default_factory=time.time)
    state: int = STATE_DRAFT
    attendee_ids: list = field(default_factory=list)


@dataclass(eq=False)
class Screenshot:
    """server/Screenshot.h: a rendered screenshot (or map tile) record."""

    screenshot_id: int = 0
    # Camera request (the screenshot bot fulfils these; ScreenshotBot flow)
    cam_pos: tuple = (0.0, 0.0, 0.0)
    cam_angles: tuple = (0.0, 0.0)
    width: int = 512
    is_map_tile: bool = False
    tile_x: int = 0
    tile_y: int = 0
    tile_z: int = 0
    state_done: bool = False
    created_time: float = field(default_factory=time.time)
    data: bytes = b""                   # PNG payload once rendered


class SiteDataStore:
    """Aggregated site content with id allocation (the slice of
    ServerAllWorldsState that the web handlers read/write)."""

    def __init__(self):
        self.lock = threading.RLock()
        self.news_posts: dict[int, NewsPost] = {}
        self.events: dict[int, SubEvent] = {}
        self.screenshots: dict[int, Screenshot] = {}
        self.map_tiles: dict[tuple, int] = {}      # (x, y, z) -> screenshot id
        self.next_news_id = 1
        self.next_event_id = 1
        self.next_screenshot_id = 1

    # -- news --
    def create_news_post(self, creator_id: int, title: str,
                         content: str) -> NewsPost:
        with self.lock:
            p = NewsPost(post_id=self.next_news_id, creator_id=creator_id,
                         title=title, content=content)
            self.next_news_id += 1
            self.news_posts[p.post_id] = p
            return p

    def published_news(self) -> list[NewsPost]:
        with self.lock:
            return sorted((p for p in self.news_posts.values() if p.published),
                          key=lambda p: -p.created_time)

    # -- events --
    def create_event(self, creator_id: int, world_name: str, title: str,
                     description: str, start_time: float,
                     end_time: float) -> SubEvent:
        with self.lock:
            e = SubEvent(event_id=self.next_event_id, creator_id=creator_id,
                         world_name=world_name, title=title,
                         description=description, start_time=start_time,
                         end_time=end_time)
            self.next_event_id += 1
            self.events[e.event_id] = e
            return e

    def upcoming_events(self, now: float | None = None) -> list[SubEvent]:
        now = time.time() if now is None else now
        with self.lock:
            return sorted(
                (e for e in self.events.values()
                 if e.state == SubEvent.STATE_PUBLISHED and e.end_time >= now),
                key=lambda e: e.start_time)

    # -- screenshots / map tiles --
    def add_screenshot(self, data: bytes = b"", *, is_map_tile=False,
                       tile_x=0, tile_y=0, tile_z=0,
                       cam_pos=(0.0, 0.0, 0.0)) -> Screenshot:
        with self.lock:
            s = Screenshot(screenshot_id=self.next_screenshot_id,
                           cam_pos=tuple(cam_pos), is_map_tile=is_map_tile,
                           tile_x=tile_x, tile_y=tile_y, tile_z=tile_z,
                           data=data, state_done=bool(data))
            self.next_screenshot_id += 1
            self.screenshots[s.screenshot_id] = s
            if is_map_tile:
                self.map_tiles[(tile_x, tile_y, tile_z)] = s.screenshot_id
            return s

    def tile(self, x: int, y: int, z: int) -> Screenshot | None:
        with self.lock:
            sid = self.map_tiles.get((x, y, z))
            return self.screenshots.get(sid) if sid is not None else None
