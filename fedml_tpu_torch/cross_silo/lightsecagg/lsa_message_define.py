"""LightSecAgg cross-silo message constants (copy of
``fedml_tpu.cross_silo.lightsecagg.lsa_message_define``).

Protocol:
    1 (server initializes the model parameters)
 -> 5 (clients send encoded mask shares to other clients via the server)
 -> 2 (the server routes each encoded mask share to its target client)
 ========= the client is doing the model training =========
 -> 6 (send the trained, masked model to the server)
 -> 4 (the server asks the active users to upload the aggregate mask)
 -> 7 (clients send the aggregate of their received mask shares)
 =========           model aggregation            =========
 -> 3 (the server sends the aggregated model to all clients)
"""


class MyMessage:
    MSG_TYPE_CONNECTION_IS_READY = 0

    # server -> client
    MSG_TYPE_S2C_INIT_CONFIG = 1
    MSG_TYPE_S2C_ENCODED_MASK_TO_CLIENT = 2
    MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT = 3
    MSG_TYPE_S2C_SEND_TO_ACTIVE_CLIENT = 4
    MSG_TYPE_S2C_FINISH = 10

    # client -> server
    MSG_TYPE_C2S_SEND_ENCODED_MASK_TO_SERVER = 5
    MSG_TYPE_C2S_SEND_MODEL_TO_SERVER = 6
    MSG_TYPE_C2S_SEND_MASK_TO_SERVER = 7
    MSG_TYPE_C2S_CLIENT_STATUS = 8

    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_MASKED_PARAMS = "masked_params"
    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    MSG_ARG_KEY_ROUND_IDX = "round_idx"
    MSG_ARG_KEY_ENCODED_MASK = "encoded_mask"
    MSG_ARG_KEY_ACTIVE_CLIENTS = "active_clients"
    MSG_ARG_KEY_AGGREGATE_ENCODED_MASK = "aggregate_encoded_mask"
    MSG_ARG_KEY_CLIENT_ID = "client_id"
