from .engine import (ContinuousBatcher, Engine, Request, SlotBatcher,
                     SlotState)
