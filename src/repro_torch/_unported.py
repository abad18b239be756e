"""What the port does not have yet, named for the errors that refuse it
(a leaf: it imports nothing, so any module may raise with it)."""

ITEM_11_5 = ("ROADMAP Queue 1 item 11.5 (the sharded train state: "
             "ElasticController, restore_checkpoint(shardings=...) and "
             "ResilientLoop.run(state_shardings=...))")
