"""sub:// URL parsing/building (gui_client/URLParser.cpp semantics).

A copy of ``substrata_tpu/shared/sub_url.py``: importing any module of the
reference package loads jax, so the port keeps its own.

Format: sub://hostname[/worldname | /parcel/N][?x=..&y=..&z=..&heading=..&
world=..&sun_vert_angle=..&sun_azimuth_angle=..]
The protocol prefix is optional (URLParser.cpp:39 allows bare hostnames).
"""

from __future__ import annotations

import urllib.parse
from dataclasses import dataclass


@dataclass
class SubURL:
    hostname: str = ""
    worldname: str = ""
    parcel_uid: int | None = None
    x: float | None = None
    y: float | None = None
    z: float | None = None
    heading: float | None = None   # degrees

    @property
    def has_position(self) -> bool:
        return self.x is not None and self.y is not None and self.z is not None


def parse_sub_url(url: str) -> SubURL:
    s = url.strip()
    if "://" in s:
        proto, _, s = s.partition("://")
        if proto != "sub":
            raise ValueError(f"unhandled protocol scheme '{proto}'")
    elif ":" in s.split("/", 1)[0]:
        raise ValueError("malformed URL")
    res = SubURL()
    path, _, query = s.partition("?")
    host, slash, rest = path.partition("/")
    res.hostname = host
    if slash:
        if rest.startswith("parcel/"):
            res.parcel_uid = int(rest[len("parcel/"):].split("/")[0])
        else:
            res.worldname = urllib.parse.unquote_plus(rest)
    q = urllib.parse.parse_qs(query)
    if "x" in q:
        res.x = float(q["x"][0])
    if "y" in q:
        res.y = float(q["y"][0])
    if "z" in q:
        res.z = float(q["z"][0])
    if "heading" in q:
        res.heading = float(q["heading"][0])
    if "world" in q:
        res.worldname = q["world"][0]
    return res


def make_sub_url(hostname: str, worldname: str = "", pos=None,
                 heading: float | None = None) -> str:
    url = f"sub://{hostname}"
    if worldname:
        url += "/" + urllib.parse.quote(worldname)
    params = []
    if pos is not None:
        params += [f"x={pos[0]:.2f}", f"y={pos[1]:.2f}", f"z={pos[2]:.2f}"]
    if heading is not None:
        params.append(f"heading={heading:.1f}")
    if params:
        url += "?" + "&".join(params)
    return url
