"""Pydantic result schemas (parity with reference src/yolo/schemas.py:6-89).

A copy of yolo_tpu/schemas.py. Import it only where a ``Detection`` is
built: it pulls in pydantic.
"""

from __future__ import annotations

from pydantic import BaseModel, Field


class BoundingBox(BaseModel):
    """Bounding box in normalized center coordinates (0-1)."""

    x: float = Field(..., ge=0.0, le=1.0, description="Center x (normalized)")
    y: float = Field(..., ge=0.0, le=1.0, description="Center y (normalized)")
    width: float = Field(..., ge=0.0, le=1.0, description="Width (normalized)")
    height: float = Field(..., ge=0.0, le=1.0, description="Height (normalized)")

    def to_corners(self) -> tuple[float, float, float, float]:
        """Center format -> (x1, y1, x2, y2) corners, normalized."""
        half_w = self.width / 2
        half_h = self.height / 2
        return (self.x - half_w, self.y - half_h, self.x + half_w, self.y + half_h)

    def to_pixel_coords(
        self, img_width: int, img_height: int
    ) -> tuple[int, int, int, int]:
        """Corners scaled to pixel coordinates (int-truncated like the reference)."""
        x1, y1, x2, y2 = self.to_corners()
        return (
            int(x1 * img_width),
            int(y1 * img_height),
            int(x2 * img_width),
            int(y2 * img_height),
        )

    @property
    def area(self) -> float:
        """Normalized box area (width * height)."""
        return self.width * self.height

    @classmethod
    def from_corners(
        cls, x1: float, y1: float, x2: float, y2: float
    ) -> "BoundingBox":
        """Build from corner coordinates."""
        width = x2 - x1
        height = y2 - y1
        return cls(x=x1 + width / 2, y=y1 + height / 2, width=width, height=height)

    def __str__(self) -> str:
        x1, y1, x2, y2 = self.to_corners()
        return f"({x1:.2f}, {y1:.2f}, {x2:.2f}, {y2:.2f})"


class Detection(BaseModel):
    """Single object detection: class, confidence, box."""

    class_id: int = Field(..., ge=0, description="Predicted class ID")
    class_name: str | None = Field(None, description="Class name, if known")
    confidence: float = Field(..., ge=0.0, le=1.0, description="Confidence score")
    bbox: BoundingBox = Field(..., description="Bounding box coordinates")
