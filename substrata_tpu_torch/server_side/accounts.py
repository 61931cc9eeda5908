"""User accounts, sessions, API keys, password resets, auctions, orders.

Parity with server/User.{h,cpp} (salted password hashing), UserWebSession,
APIKey, PasswordReset, ParcelAuction + AuctionLock, Order — the account and
commerce records behind the web handlers and parcel system.

A copy of ``substrata_tpu/server_side/accounts.py`` with the port's imports: importing
any module of the reference package loads jax, so the port keeps its own.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import secrets
import time
from dataclasses import dataclass, field
from enum import IntEnum


def _hash_password(password: str, salt: bytes) -> bytes:
    # scrypt like modern glare builds (reference: salted SHA-256 iterations).
    return hashlib.scrypt(password.encode("utf-8"), salt=salt,
                          n=2 ** 14, r=8, p=1, dklen=32)


@dataclass(eq=False)
class User:
    user_id: int = 0
    name: str = ""
    email: str = ""
    created_time: float = field(default_factory=time.time)
    hashed_password: bytes = b""
    password_salt: bytes = b""
    flags: int = 0
    avatar_settings: object = None

    # server/User.h:90-91 permission flag bits.
    WORLD_GARDENER_FLAG = 1          # may add objects outside parcels
    ALLOW_DYN_TEX_UPDATE_CHECKING = 2

    @property
    def is_world_gardener(self) -> bool:
        return bool(self.flags & User.WORLD_GARDENER_FLAG)

    def set_password(self, password: str):
        self.password_salt = os.urandom(16)
        self.hashed_password = _hash_password(password, self.password_salt)

    def is_password_valid(self, password: str) -> bool:
        if not self.hashed_password:
            return False
        return hmac.compare_digest(
            self.hashed_password, _hash_password(password, self.password_salt))


@dataclass(eq=False)
class UserWebSession:
    """Web login session (server/UserWebSession.h): opaque id cookie."""

    session_id: str = field(default_factory=lambda: secrets.token_urlsafe(32))
    user_id: int = 0
    created_time: float = field(default_factory=time.time)

    EXPIRY = 30 * 24 * 3600.0

    def expired(self, now=None) -> bool:
        return ((now or time.time()) - self.created_time) > self.EXPIRY


@dataclass(eq=False)
class APIKey:
    key: str = field(default_factory=lambda: secrets.token_hex(24))
    user_id: int = 0
    created_time: float = field(default_factory=time.time)
    revoked: bool = False


@dataclass(eq=False)
class PasswordReset:
    token: str = field(default_factory=lambda: secrets.token_urlsafe(24))
    user_id: int = 0
    created_time: float = field(default_factory=time.time)

    EXPIRY = 3600.0

    def expired(self, now=None) -> bool:
        return ((now or time.time()) - self.created_time) > self.EXPIRY


class AuctionState(IntEnum):
    FOR_SALE = 0
    SOLD = 1
    NOT_SOLD = 2


@dataclass(eq=False)
class ParcelAuction:
    """Dutch-style descending-price parcel auction (server/ParcelAuction.h)."""

    auction_id: int = 0
    parcel_id: int = 0
    state: int = int(AuctionState.FOR_SALE)
    start_time: float = 0.0
    end_time: float = 0.0
    start_price: float = 0.0
    end_price: float = 0.0
    sold_price: float = 0.0
    sold_to_user_id: int = 0
    # AuctionLock: a buyer holds the price briefly while paying.
    lock_user_id: int = 0
    lock_expiry: float = 0.0

    LOCK_DURATION = 300.0

    def current_price(self, now: float) -> float:
        if now <= self.start_time:
            return self.start_price
        if now >= self.end_time:
            return self.end_price
        f = (now - self.start_time) / max(self.end_time - self.start_time, 1e-9)
        return self.start_price + (self.end_price - self.start_price) * f

    def try_lock(self, user_id: int, now: float) -> bool:
        if self.state != int(AuctionState.FOR_SALE):
            return False
        if self.lock_user_id and now < self.lock_expiry and self.lock_user_id != user_id:
            return False
        self.lock_user_id = user_id
        self.lock_expiry = now + self.LOCK_DURATION
        return True

    def complete_sale(self, user_id: int, now: float) -> bool:
        if self.state != int(AuctionState.FOR_SALE):
            return False
        if self.lock_user_id != user_id or now >= self.lock_expiry:
            return False
        self.state = int(AuctionState.SOLD)
        self.sold_price = self.current_price(now)
        self.sold_to_user_id = user_id
        return True


@dataclass(eq=False)
class Order:
    """Purchase record (server/Order.h)."""

    order_id: int = 0
    user_id: int = 0
    parcel_id: int = 0
    created_time: float = field(default_factory=time.time)
    price: float = 0.0
    confirmed: bool = False


class AccountStore:
    """In-memory + record-DB backed account registry (ServerAllWorldsState
    holds users the same way)."""

    def __init__(self, db=None):
        self.db = db
        self.users: dict[int, User] = {}
        self.users_by_name: dict[str, User] = {}
        self.sessions: dict[str, UserWebSession] = {}
        self.api_keys: dict[str, APIKey] = {}
        self.password_resets: dict[str, PasswordReset] = {}
        self.next_user_id = 1
        # Admin model (ObjectPermissions.cpp:65: "god user"; the reference
        # hardwires id 0 — here the first created user is god by default and
        # more can be granted).  User ids here start at 1.
        self.god_user_ids: set[int] = {1}
        # server/UserSecret.h: per-user named secrets (scripts read them).
        self.user_secrets: dict[int, dict[str, str]] = {}
        self.auctions: dict[int, ParcelAuction] = {}
        self.orders: dict[int, Order] = {}
        self.next_auction_id = 1
        self.next_order_id = 1
        # Photos + chatbot configs (server/Photo.h, server/ChatBot.h; the
        # reference keeps both in ServerAllWorldsState alongside users).
        self.photos: dict[int, object] = {}
        self.next_photo_id = 1
        self.chatbots: dict[int, object] = {}
        self.next_chatbot_id = 1

    def create_user(self, name: str, email: str, password: str) -> User:
        if name in self.users_by_name:
            raise ValueError("username taken")
        u = User(user_id=self.next_user_id, name=name, email=email)
        self.next_user_id += 1
        u.set_password(password)
        self.users[u.user_id] = u
        self.users_by_name[name] = u
        return u

    def login(self, name: str, password: str) -> UserWebSession | None:
        u = self.users_by_name.get(name)
        if u is None or not u.is_password_valid(password):
            return None
        s = UserWebSession(user_id=u.user_id)
        self.sessions[s.session_id] = s
        return s

    def user_for_session(self, session_id: str) -> User | None:
        s = self.sessions.get(session_id)
        if s is None or s.expired():
            return None
        return self.users.get(s.user_id)

    def logout(self, session_id: str):
        self.sessions.pop(session_id, None)

    def create_api_key(self, user_id: int) -> APIKey:
        k = APIKey(user_id=user_id)
        self.api_keys[k.key] = k
        return k

    def user_for_api_key(self, key: str) -> User | None:
        k = self.api_keys.get(key)
        if k is None or k.revoked:
            return None
        return self.users.get(k.user_id)

    def request_password_reset(self, name: str) -> PasswordReset | None:
        u = self.users_by_name.get(name)
        if u is None:
            return None
        pr = PasswordReset(user_id=u.user_id)
        self.password_resets[pr.token] = pr
        return pr

    def is_god_user(self, user_id: int) -> bool:
        """ObjectPermissions.cpp:65 isGodUser equivalent."""
        return user_id in self.god_user_ids

    def change_password(self, user_id: int, old: str, new: str) -> bool:
        u = self.users.get(user_id)
        if u is None or not u.is_password_valid(old):
            return False
        u.set_password(new)
        return True

    def revoke_api_key(self, user_id: int, key: str) -> bool:
        k = self.api_keys.get(key)
        if k is None or k.user_id != user_id:
            return False
        k.revoked = True
        return True

    # -- user secrets (server/UserSecret.h) --
    def add_secret(self, user_id: int, name: str, value: str):
        self.user_secrets.setdefault(user_id, {})[name] = value

    def delete_secret(self, user_id: int, name: str) -> bool:
        return self.user_secrets.get(user_id, {}).pop(name, None) is not None

    def secrets_for_user(self, user_id: int) -> dict[str, str]:
        return dict(self.user_secrets.get(user_id, {}))

    # -- auctions + orders (server/ParcelAuction.h, Order.h registries) --
    def create_auction(self, parcel_id: int, start_price: float,
                       end_price: float, start_time: float,
                       end_time: float) -> ParcelAuction:
        a = ParcelAuction(auction_id=self.next_auction_id,
                          parcel_id=parcel_id, start_price=start_price,
                          end_price=end_price, start_time=start_time,
                          end_time=end_time)
        self.next_auction_id += 1
        self.auctions[a.auction_id] = a
        return a

    def create_order(self, user_id: int, parcel_id: int,
                     price: float) -> Order:
        o = Order(order_id=self.next_order_id, user_id=user_id,
                  parcel_id=parcel_id, price=price)
        self.next_order_id += 1
        self.orders[o.order_id] = o
        return o

    def create_photo(self, **kw):
        raise NotImplementedError(
            "photos are commerce records, not ported yet (ROADMAP.md queue 1, "
            "item 8: server_side/commerce.py and the webserver)")

    def create_chatbot(self, **kw):
        raise NotImplementedError(
            "chatbots are commerce records, not ported yet (ROADMAP.md queue 1, "
            "item 8: server_side/commerce.py and the webserver)")

    def reset_password(self, token: str, new_password: str) -> bool:
        pr = self.password_resets.pop(token, None)
        if pr is None or pr.expired():
            return False
        u = self.users.get(pr.user_id)
        if u is None:
            return False
        u.set_password(new_password)
        # Invalidate existing sessions for the user.
        self.sessions = {sid: s for sid, s in self.sessions.items()
                         if s.user_id != u.user_id}
        return True
