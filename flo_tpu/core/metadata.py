"""flo metadata: ID3v2.4-compatible fields + flo-unique extensions.

Byte-compatible mirror of libflo/src/core/metadata.rs (FloMetadata and ~30
sub-structures). Serialization matches `rmp_serde::to_vec_named` semantics
(metadata.rs:708-716): MessagePack maps keyed by field name, fields emitted in
struct declaration order, `Option::None`/empty-Vec/empty-map fields omitted
per the reference's skip_serializing_if attributes, enums as snake_case
strings, binary blobs as msgpack bin, and f32 fields packed as float32
(msgpack ``use_single_float``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import msgpack


class PictureType(str, enum.Enum):
    """ID3v2.4 APIC picture types (metadata.rs:14-39)."""

    OTHER = "other"
    FILE_ICON = "file_icon"
    OTHER_FILE_ICON = "other_file_icon"
    COVER_FRONT = "cover_front"
    COVER_BACK = "cover_back"
    LEAFLET_PAGE = "leaflet_page"
    MEDIA = "media"
    LEAD_ARTIST = "lead_artist"
    ARTIST = "artist"
    CONDUCTOR = "conductor"
    BAND = "band"
    COMPOSER = "composer"
    LYRICIST = "lyricist"
    RECORDING_LOCATION = "recording_location"
    DURING_RECORDING = "during_recording"
    DURING_PERFORMANCE = "during_performance"
    VIDEO_SCREEN_CAPTURE = "video_screen_capture"
    BRIGHT_COLOURED_FISH = "bright_coloured_fish"  # yes, real in ID3v2.4
    ILLUSTRATION = "illustration"
    BAND_LOGO = "band_logo"
    PUBLISHER_LOGO = "publisher_logo"


class SyncedLyricsContentType(str, enum.Enum):
    OTHER = "other"
    LYRICS = "lyrics"
    TEXT_TRANSCRIPTION = "text_transcription"
    PART_NAME = "part_name"
    EVENTS = "events"
    CHORD = "chord"
    TRIVIA = "trivia"
    WEBPAGE_URL = "webpage_url"
    IMAGE_URL = "image_url"


class SectionType(str, enum.Enum):
    INTRO = "intro"
    VERSE = "verse"
    PRE_CHORUS = "pre_chorus"
    CHORUS = "chorus"
    POST_CHORUS = "post_chorus"
    BRIDGE = "bridge"
    BREAKDOWN = "breakdown"
    DROP = "drop"
    BUILDUP = "buildup"
    SOLO = "solo"
    INSTRUMENTAL = "instrumental"
    OUTRO = "outro"
    SILENCE = "silence"
    OTHER = "other"


class CoverVariantType(str, enum.Enum):
    STANDARD = "standard"
    EXPLICIT = "explicit"
    CLEAN = "clean"
    REMIX = "remix"
    DELUXE = "deluxe"
    LIMITED = "limited"
    VINYL = "vinyl"
    CASSETTE = "cassette"
    DIGITAL = "digital"
    OTHER = "other"


@dataclass
class Picture:
    """Attached picture, APIC (metadata.rs:42-53)."""

    mime_type: str = ""
    picture_type: PictureType = PictureType.COVER_FRONT
    description: Optional[str] = None
    data: bytes = b""

    def to_obj(self) -> dict:
        d = {"mime_type": self.mime_type, "picture_type": self.picture_type.value}
        if self.description is not None:
            d["description"] = self.description
        d["data"] = bytes(self.data)
        return d

    @classmethod
    def from_obj(cls, d: dict) -> "Picture":
        return cls(
            mime_type=d.get("mime_type", ""),
            picture_type=PictureType(d.get("picture_type", "cover_front")),
            description=d.get("description"),
            data=bytes(d.get("data", b"")),
        )


@dataclass
class Comment:
    """COMM (metadata.rs:60-70)."""

    text: str = ""
    language: Optional[str] = None
    description: Optional[str] = None

    def to_obj(self) -> dict:
        d = {}
        if self.language is not None:
            d["language"] = self.language
        if self.description is not None:
            d["description"] = self.description
        d["text"] = self.text
        return d

    @classmethod
    def from_obj(cls, d: dict) -> "Comment":
        return cls(
            text=d.get("text", ""),
            language=d.get("language"),
            description=d.get("description"),
        )


@dataclass
class Lyrics:
    """USLT (metadata.rs:73-83)."""

    text: str = ""
    language: Optional[str] = None
    description: Optional[str] = None

    to_obj = Comment.to_obj
    from_obj = classmethod(Comment.from_obj.__func__)


@dataclass
class SyncedLyricsLine:
    timestamp_ms: int = 0
    text: str = ""

    def to_obj(self) -> dict:
        return {"timestamp_ms": int(self.timestamp_ms), "text": self.text}

    @classmethod
    def from_obj(cls, d: dict) -> "SyncedLyricsLine":
        return cls(timestamp_ms=int(d.get("timestamp_ms", 0)), text=d.get("text", ""))


@dataclass
class SyncedLyrics:
    """SYLT (metadata.rs:108-121)."""

    language: Optional[str] = None
    content_type: SyncedLyricsContentType = SyncedLyricsContentType.LYRICS
    description: Optional[str] = None
    lines: List[SyncedLyricsLine] = field(default_factory=list)

    def to_obj(self) -> dict:
        d = {}
        if self.language is not None:
            d["language"] = self.language
        d["content_type"] = self.content_type.value
        if self.description is not None:
            d["description"] = self.description
        d["lines"] = [ln.to_obj() for ln in self.lines]
        return d

    @classmethod
    def from_obj(cls, d: dict) -> "SyncedLyrics":
        return cls(
            language=d.get("language"),
            content_type=SyncedLyricsContentType(d.get("content_type", "lyrics")),
            description=d.get("description"),
            lines=[SyncedLyricsLine.from_obj(x) for x in d.get("lines", [])],
        )


@dataclass
class UserText:
    """TXXX (metadata.rs:124-130)."""

    description: str = ""
    value: str = ""

    def to_obj(self) -> dict:
        return {"description": self.description, "value": self.value}

    @classmethod
    def from_obj(cls, d: dict) -> "UserText":
        return cls(description=d.get("description", ""), value=d.get("value", ""))


@dataclass
class UserUrl:
    """WXXX (metadata.rs:133-139)."""

    description: str = ""
    url: str = ""

    def to_obj(self) -> dict:
        return {"description": self.description, "url": self.url}

    @classmethod
    def from_obj(cls, d: dict) -> "UserUrl":
        return cls(description=d.get("description", ""), url=d.get("url", ""))


@dataclass
class Popularimeter:
    """POPM (metadata.rs:142-152)."""

    rating: int = 0
    email: Optional[str] = None
    play_count: Optional[int] = None

    def to_obj(self) -> dict:
        d = {}
        if self.email is not None:
            d["email"] = self.email
        d["rating"] = int(self.rating)
        if self.play_count is not None:
            d["play_count"] = int(self.play_count)
        return d

    @classmethod
    def from_obj(cls, d: dict) -> "Popularimeter":
        return cls(
            rating=int(d.get("rating", 0)),
            email=d.get("email"),
            play_count=d.get("play_count"),
        )


@dataclass
class WaveformData:
    """Pre-computed waveform peaks (metadata.rs:159-171)."""

    peaks_per_second: int = 50
    peaks: List[float] = field(default_factory=list)
    channels: int = 1

    def to_obj(self) -> dict:
        return {
            "peaks_per_second": int(self.peaks_per_second),
            "peaks": [float(p) for p in self.peaks],
            "channels": int(self.channels),
        }

    @classmethod
    def from_obj(cls, d: dict) -> "WaveformData":
        return cls(
            peaks_per_second=int(d.get("peaks_per_second", 50)),
            peaks=[float(p) for p in d.get("peaks", [])],
            channels=int(d.get("channels", 1)),
        )


@dataclass
class SectionMarker:
    timestamp_ms: int = 0
    section_type: SectionType = SectionType.OTHER
    label: Optional[str] = None

    def to_obj(self) -> dict:
        d = {"timestamp_ms": int(self.timestamp_ms), "section_type": self.section_type.value}
        if self.label is not None:
            d["label"] = self.label
        return d

    @classmethod
    def from_obj(cls, d: dict) -> "SectionMarker":
        return cls(
            timestamp_ms=int(d.get("timestamp_ms", 0)),
            section_type=SectionType(d.get("section_type", "other")),
            label=d.get("label"),
        )


@dataclass
class BpmChange:
    timestamp_ms: int = 0
    bpm: float = 0.0

    def to_obj(self) -> dict:
        return {"timestamp_ms": int(self.timestamp_ms), "bpm": float(self.bpm)}

    @classmethod
    def from_obj(cls, d: dict) -> "BpmChange":
        return cls(timestamp_ms=int(d.get("timestamp_ms", 0)), bpm=float(d.get("bpm", 0.0)))


@dataclass
class KeyChange:
    timestamp_ms: int = 0
    key: str = ""

    def to_obj(self) -> dict:
        return {"timestamp_ms": int(self.timestamp_ms), "key": self.key}

    @classmethod
    def from_obj(cls, d: dict) -> "KeyChange":
        return cls(timestamp_ms=int(d.get("timestamp_ms", 0)), key=d.get("key", ""))


@dataclass
class LoudnessPoint:
    timestamp_ms: int = 0
    lufs: float = 0.0

    def to_obj(self) -> dict:
        return {"timestamp_ms": int(self.timestamp_ms), "lufs": float(self.lufs)}

    @classmethod
    def from_obj(cls, d: dict) -> "LoudnessPoint":
        return cls(timestamp_ms=int(d.get("timestamp_ms", 0)), lufs=float(d.get("lufs", 0.0)))


@dataclass
class CreatorNote:
    text: str = ""
    timestamp_ms: Optional[int] = None

    def to_obj(self) -> dict:
        d = {}
        if self.timestamp_ms is not None:
            d["timestamp_ms"] = int(self.timestamp_ms)
        d["text"] = self.text
        return d

    @classmethod
    def from_obj(cls, d: dict) -> "CreatorNote":
        return cls(text=d.get("text", ""), timestamp_ms=d.get("timestamp_ms"))


@dataclass
class CollaborationCredit:
    role: str = ""
    name: str = ""
    timestamp_ms: Optional[int] = None

    def to_obj(self) -> dict:
        d = {"role": self.role, "name": self.name}
        if self.timestamp_ms is not None:
            d["timestamp_ms"] = int(self.timestamp_ms)
        return d

    @classmethod
    def from_obj(cls, d: dict) -> "CollaborationCredit":
        return cls(
            role=d.get("role", ""),
            name=d.get("name", ""),
            timestamp_ms=d.get("timestamp_ms"),
        )


@dataclass
class RemixChainEntry:
    title: str = ""
    artist: str = ""
    relationship: str = "original"
    year: Optional[int] = None
    isrc: Optional[str] = None

    def to_obj(self) -> dict:
        d = {"title": self.title, "artist": self.artist}
        if self.year is not None:
            d["year"] = int(self.year)
        if self.isrc is not None:
            d["isrc"] = self.isrc
        d["relationship"] = self.relationship
        return d

    @classmethod
    def from_obj(cls, d: dict) -> "RemixChainEntry":
        return cls(
            title=d.get("title", ""),
            artist=d.get("artist", ""),
            relationship=d.get("relationship", "original"),
            year=d.get("year"),
            isrc=d.get("isrc"),
        )


@dataclass
class AnimatedCover:
    mime_type: str = ""
    data: bytes = b""
    duration_ms: Optional[int] = None
    loop_count: Optional[int] = None

    def to_obj(self) -> dict:
        d = {"mime_type": self.mime_type, "data": bytes(self.data)}
        if self.duration_ms is not None:
            d["duration_ms"] = int(self.duration_ms)
        if self.loop_count is not None:
            d["loop_count"] = int(self.loop_count)
        return d

    @classmethod
    def from_obj(cls, d: dict) -> "AnimatedCover":
        return cls(
            mime_type=d.get("mime_type", ""),
            data=bytes(d.get("data", b"")),
            duration_ms=d.get("duration_ms"),
            loop_count=d.get("loop_count"),
        )


@dataclass
class CoverVariant:
    variant_type: CoverVariantType = CoverVariantType.STANDARD
    mime_type: str = ""
    data: bytes = b""
    description: Optional[str] = None

    def to_obj(self) -> dict:
        d = {
            "variant_type": self.variant_type.value,
            "mime_type": self.mime_type,
            "data": bytes(self.data),
        }
        if self.description is not None:
            d["description"] = self.description
        return d

    @classmethod
    def from_obj(cls, d: dict) -> "CoverVariant":
        return cls(
            variant_type=CoverVariantType(d.get("variant_type", "standard")),
            mime_type=d.get("mime_type", ""),
            data=bytes(d.get("data", b"")),
            description=d.get("description"),
        )


#: (python field, kind) in exact struct declaration order (metadata.rs:327-663).
#: kinds: opt (skip None), vec (skip empty; items have to_obj), vec_plain
#: (skip empty; plain values), pairs (skip None; list of 2-tuples), obj (skip
#: None; has to_obj), bytes_opt (skip None), map (skip empty), f32_opt.
_FIELDS: List[Tuple[str, str, object]] = [
    ("title", "opt", None),
    ("subtitle", "opt", None),
    ("content_group", "opt", None),
    ("album", "opt", None),
    ("original_album", "opt", None),
    ("set_subtitle", "opt", None),
    ("track_number", "opt", None),
    ("track_total", "opt", None),
    ("disc_number", "opt", None),
    ("disc_total", "opt", None),
    ("isrc", "opt", None),
    ("artist", "opt", None),
    ("album_artist", "opt", None),
    ("conductor", "opt", None),
    ("remixer", "opt", None),
    ("original_artist", "opt", None),
    ("composer", "opt", None),
    ("lyricist", "opt", None),
    ("original_lyricist", "opt", None),
    ("encoded_by", "opt", None),
    ("involved_people", "pairs", None),
    ("musician_credits", "pairs", None),
    ("genre", "opt", None),
    ("mood", "opt", None),
    ("bpm", "opt", None),
    ("key", "opt", None),
    ("language", "opt", None),
    ("length_ms", "opt", None),
    ("year", "opt", None),
    ("recording_time", "opt", None),
    ("release_time", "opt", None),
    ("original_release_time", "opt", None),
    ("encoding_time", "opt", None),
    ("tagging_time", "opt", None),
    ("copyright", "opt", None),
    ("produced_notice", "opt", None),
    ("publisher", "opt", None),
    ("file_owner", "opt", None),
    ("radio_station", "opt", None),
    ("radio_station_owner", "opt", None),
    ("album_sort", "opt", None),
    ("artist_sort", "opt", None),
    ("title_sort", "opt", None),
    ("original_filename", "opt", None),
    ("playlist_delay", "opt", None),
    ("encoder_settings", "opt", None),
    ("url_commercial", "opt", None),
    ("url_copyright", "opt", None),
    ("url_audio_file", "opt", None),
    ("url_artist", "opt", None),
    ("url_audio_source", "opt", None),
    ("url_radio_station", "opt", None),
    ("url_payment", "opt", None),
    ("url_publisher", "opt", None),
    ("user_urls", "vec", UserUrl),
    ("comments", "vec", Comment),
    ("lyrics", "vec", Lyrics),
    ("synced_lyrics", "vec", SyncedLyrics),
    ("pictures", "vec", Picture),
    ("user_text", "vec", UserText),
    ("play_count", "opt", None),
    ("popularimeter", "obj", Popularimeter),
    ("waveform_data", "obj", WaveformData),
    ("spectrum_fingerprint", "bytes_opt", None),
    ("bpm_map", "vec", BpmChange),
    ("key_changes", "vec", KeyChange),
    ("loudness_profile", "vec", LoudnessPoint),
    ("integrated_loudness_lufs", "f32_opt", None),
    ("loudness_range_lu", "f32_opt", None),
    ("true_peak_dbtp", "f32_opt", None),
    ("section_markers", "vec", SectionMarker),
    ("creator_notes", "vec", CreatorNote),
    ("collaboration_credits", "vec", CollaborationCredit),
    ("remix_chain", "vec", RemixChainEntry),
    ("animated_cover", "obj", AnimatedCover),
    ("cover_variants", "vec", CoverVariant),
    ("artist_signature", "obj", Picture),
    ("flo_encoder_version", "opt", None),
    ("source_format", "opt", None),
    ("custom", "map", None),
]


@dataclass
class FloMetadata:
    """Main metadata container (metadata.rs:326-663)."""

    # identification
    title: Optional[str] = None
    subtitle: Optional[str] = None
    content_group: Optional[str] = None
    album: Optional[str] = None
    original_album: Optional[str] = None
    set_subtitle: Optional[str] = None
    track_number: Optional[int] = None
    track_total: Optional[int] = None
    disc_number: Optional[int] = None
    disc_total: Optional[int] = None
    isrc: Optional[str] = None
    # involved persons
    artist: Optional[str] = None
    album_artist: Optional[str] = None
    conductor: Optional[str] = None
    remixer: Optional[str] = None
    original_artist: Optional[str] = None
    composer: Optional[str] = None
    lyricist: Optional[str] = None
    original_lyricist: Optional[str] = None
    encoded_by: Optional[str] = None
    involved_people: Optional[List[Tuple[str, str]]] = None
    musician_credits: Optional[List[Tuple[str, str]]] = None
    # properties
    genre: Optional[str] = None
    mood: Optional[str] = None
    bpm: Optional[int] = None
    key: Optional[str] = None
    language: Optional[str] = None
    length_ms: Optional[int] = None
    # dates/times
    year: Optional[int] = None
    recording_time: Optional[str] = None
    release_time: Optional[str] = None
    original_release_time: Optional[str] = None
    encoding_time: Optional[str] = None
    tagging_time: Optional[str] = None
    # rights/license
    copyright: Optional[str] = None
    produced_notice: Optional[str] = None
    publisher: Optional[str] = None
    file_owner: Optional[str] = None
    radio_station: Optional[str] = None
    radio_station_owner: Optional[str] = None
    # sort order
    album_sort: Optional[str] = None
    artist_sort: Optional[str] = None
    title_sort: Optional[str] = None
    # other text
    original_filename: Optional[str] = None
    playlist_delay: Optional[int] = None
    encoder_settings: Optional[str] = None
    # urls
    url_commercial: Optional[str] = None
    url_copyright: Optional[str] = None
    url_audio_file: Optional[str] = None
    url_artist: Optional[str] = None
    url_audio_source: Optional[str] = None
    url_radio_station: Optional[str] = None
    url_payment: Optional[str] = None
    url_publisher: Optional[str] = None
    user_urls: List[UserUrl] = field(default_factory=list)
    # complex frames
    comments: List[Comment] = field(default_factory=list)
    lyrics: List[Lyrics] = field(default_factory=list)
    synced_lyrics: List[SyncedLyrics] = field(default_factory=list)
    pictures: List[Picture] = field(default_factory=list)
    user_text: List[UserText] = field(default_factory=list)
    play_count: Optional[int] = None
    popularimeter: Optional[Popularimeter] = None
    # visualization (flo-unique)
    waveform_data: Optional[WaveformData] = None
    spectrum_fingerprint: Optional[bytes] = None
    # timing & analysis (flo-unique)
    bpm_map: List[BpmChange] = field(default_factory=list)
    key_changes: List[KeyChange] = field(default_factory=list)
    loudness_profile: List[LoudnessPoint] = field(default_factory=list)
    integrated_loudness_lufs: Optional[float] = None
    loudness_range_lu: Optional[float] = None
    true_peak_dbtp: Optional[float] = None
    section_markers: List[SectionMarker] = field(default_factory=list)
    # creator info (flo-unique)
    creator_notes: List[CreatorNote] = field(default_factory=list)
    collaboration_credits: List[CollaborationCredit] = field(default_factory=list)
    remix_chain: List[RemixChainEntry] = field(default_factory=list)
    # covers (flo-unique)
    animated_cover: Optional[AnimatedCover] = None
    cover_variants: List[CoverVariant] = field(default_factory=list)
    artist_signature: Optional[Picture] = None
    # flo-specific
    flo_encoder_version: Optional[str] = None
    source_format: Optional[str] = None
    custom: Dict[str, str] = field(default_factory=dict)

    # ---------------- serialization ----------------

    def to_obj(self) -> dict:
        d: dict = {}
        for name, kind, sub in _FIELDS:
            v = getattr(self, name)
            if kind == "opt":
                if v is not None:
                    d[name] = v
            elif kind == "f32_opt":
                if v is not None:
                    d[name] = float(v)
            elif kind == "bytes_opt":
                if v is not None:
                    d[name] = bytes(v)
            elif kind == "pairs":
                if v is not None:
                    d[name] = [[a, b] for a, b in v]
            elif kind == "vec":
                if v:
                    d[name] = [item.to_obj() for item in v]
            elif kind == "obj":
                if v is not None:
                    d[name] = v.to_obj()
            elif kind == "map":
                if v:
                    d[name] = dict(v)
        return d

    @classmethod
    def from_obj(cls, d: dict) -> "FloMetadata":
        m = cls()
        for name, kind, sub in _FIELDS:
            if name not in d or d[name] is None:
                continue
            v = d[name]
            if kind in ("opt", "f32_opt"):
                setattr(m, name, v)
            elif kind == "bytes_opt":
                setattr(m, name, bytes(v))
            elif kind == "pairs":
                setattr(m, name, [(a, b) for a, b in v])
            elif kind == "vec":
                setattr(m, name, [sub.from_obj(x) for x in v])
            elif kind == "obj":
                setattr(m, name, sub.from_obj(v))
            elif kind == "map":
                setattr(m, name, dict(v))
        return m

    def to_msgpack(self) -> bytes:
        """Serialize (rmp_serde::to_vec_named equivalent: named maps, f32
        floats, bin bytes)."""
        return msgpack.packb(self.to_obj())

    @classmethod
    def from_msgpack(cls, data: bytes) -> "FloMetadata":
        obj = msgpack.unpackb(data)
        if not isinstance(obj, dict):
            raise ValueError("metadata is not a msgpack map")
        return cls.from_obj(obj)

    # ---------------- helpers (metadata.rs:688-856) ----------------

    def is_empty(self) -> bool:
        return (
            self.title is None
            and self.artist is None
            and self.album is None
            and not self.pictures
            and not self.comments
            and not self.lyrics
            and not self.synced_lyrics
        )

    @classmethod
    def with_basic(cls, title=None, artist=None, album=None) -> "FloMetadata":
        return cls(title=title, artist=artist, album=album)

    def add_picture(self, mime_type: str, picture_type: PictureType, data: bytes) -> None:
        self.pictures.append(Picture(mime_type, picture_type, None, data))

    def front_cover(self) -> Optional[Picture]:
        return next(
            (p for p in self.pictures if p.picture_type == PictureType.COVER_FRONT), None
        )

    def any_picture(self) -> Optional[Picture]:
        return self.pictures[0] if self.pictures else None

    def add_comment(self, text: str, language: Optional[str] = None) -> None:
        self.comments.append(Comment(text=text, language=language))

    def add_lyrics(self, text: str, language: Optional[str] = None) -> None:
        self.lyrics.append(Lyrics(text=text, language=language))

    def add_synced_lyrics_line(
        self, timestamp_ms: int, text: str, language: Optional[str] = None
    ) -> None:
        for s in self.synced_lyrics:
            if s.language == language:
                s.lines.append(SyncedLyricsLine(timestamp_ms, text))
                return
        self.synced_lyrics.append(
            SyncedLyrics(language=language, lines=[SyncedLyricsLine(timestamp_ms, text)])
        )

    def set_custom(self, key: str, value: str) -> None:
        self.custom[key] = value

    def get_custom(self, key: str) -> Optional[str]:
        return self.custom.get(key)

    def add_section(
        self, timestamp_ms: int, section_type: SectionType, label: Optional[str] = None
    ) -> None:
        self.section_markers.append(SectionMarker(timestamp_ms, section_type, label))

    def add_bpm_change(self, timestamp_ms: int, bpm: float) -> None:
        self.bpm_map.append(BpmChange(timestamp_ms, bpm))

    def add_key_change(self, timestamp_ms: int, key: str) -> None:
        self.key_changes.append(KeyChange(timestamp_ms, key))

    def add_creator_note(self, text: str, timestamp_ms: Optional[int] = None) -> None:
        self.creator_notes.append(CreatorNote(text, timestamp_ms))

    def add_collaboration(
        self, role: str, name: str, timestamp_ms: Optional[int] = None
    ) -> None:
        self.collaboration_credits.append(CollaborationCredit(role, name, timestamp_ms))
