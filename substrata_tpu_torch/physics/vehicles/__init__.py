"""Vehicle controllers: car, bike, boat, hovercar.

Counterpart of ``substrata_tpu/physics/vehicles``: all vehicles update in
one batched pass (wheel suspension rays, tyre forces, boat and hover force
models) that produces chassis velocity deltas applied in one scatter.
"""

from substrata_tpu_torch.physics.vehicles.manager import (  # noqa: F401
    VehicleManager, VehicleSettings, VehiclePhysicsInput,
    CarPhysics, BikePhysics, BoatPhysics, HoverCarPhysics,
    VEHICLE_CAR, VEHICLE_BIKE, VEHICLE_BOAT, VEHICLE_HOVER,
)
